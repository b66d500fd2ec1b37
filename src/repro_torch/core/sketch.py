"""Count-sketch compression of hidden activations (ELSA §III.B.3,
Eqs. 20–21): Y pairwise-independent (bucket, sign) hash rows, Z buckets,
median-of-Y decoding.  Compression ratio rho = D / (Y*Z).

The counterpart of the JAX package's ``repro/core/sketch.py``.  The JAX
package re-expresses the hash as a product with a dense signed-selection
tensor for the TPU's MXU; here compress is a signed scatter and decompress
a signed gather plus median, through :mod:`repro_torch.kernels.count_sketch`
(the hand-written kernels on a CUDA tensor, their plain versions on the
CPU).  The scatter needs, for each (y, z), the features that hash there:
:class:`SketchPlan` builds that inverse index once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.count_sketch import ops as kops
from repro_torch.kernels.count_sketch.ref import median_rows


@dataclasses.dataclass(frozen=True, eq=False)
class SketchPlan:
    """The hash rows of a sketch, and their inverse (CSR) index with each
    entry's sign folded in: for each (y, b),
    ``sidx[ptr[y Z + b]:ptr[y Z + b + 1]]`` are the d with
    ``bucket[y, d] = b``, ascending, each stored as d where
    ``sign[y, d] = +1`` and as ``~d`` (that is ``-d - 1``) where it is -1.
    The index is built from ``bucket`` and ``sign`` when the plan is made
    and lives on their device; ``order`` lists the (y, b) longest list
    first (ties by (y, b)), the order in which the scatter kernel's threads
    take them.  ``gidx`` (Y, D) packs each hash entry into one int for the
    gather kernel: ``bucket[y, d]`` where ``sign[y, d] = +1``, and
    ``~bucket[y, d]`` where it is -1.

    The index needs the hash's values, which a ``meta`` tensor does not
    hold: a plan for ``meta`` is built on the CPU and moved (:meth:`to`,
    :func:`make_plan`)."""
    bucket: torch.Tensor    # (Y, D) int32 in [0, Z)
    sign: torch.Tensor      # (Y, D) float32 in {-1, +1}
    z: int
    ptr: torch.Tensor = dataclasses.field(init=False, repr=False)
    sidx: torch.Tensor = dataclasses.field(init=False, repr=False)
    order: torch.Tensor = dataclasses.field(init=False, repr=False)
    gidx: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        if self.bucket.device.type == "meta":
            raise ValueError("SketchPlan: a meta plan has no hash values to "
                             "index; build it on the CPU and move it with "
                             ".to('meta')")
        Y, D = self.bucket.shape
        b = self.bucket.to(torch.int64)
        if b.numel():
            lo, hi = torch.stack(torch.aminmax(b)).tolist()   # one sync
            if lo < 0 or hi >= self.z:
                raise ValueError(f"bucket ids must lie in [0, {self.z})")
        key = (b + self.z * torch.arange(Y, device=b.device)[:, None]
               ).reshape(-1)
        entries = torch.argsort(key, stable=True)     # (y, d) by list
        counts = torch.bincount(key, minlength=Y * self.z)
        ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        idx = entries % D
        negative = self.sign.reshape(-1)[entries] < 0
        object.__setattr__(self, "ptr", ptr.to(torch.int32))
        object.__setattr__(self, "sidx", torch.where(
            negative, -idx - 1, idx).to(torch.int32))
        object.__setattr__(self, "order", torch.argsort(
            -counts, stable=True).to(torch.int32))
        bucket = self.bucket.to(torch.int32)
        object.__setattr__(self, "gidx", torch.where(
            self.sign < 0, ~bucket, bucket).contiguous())

    def to(self, device) -> "SketchPlan":
        """The same plan with every tensor on ``device``, the index moved
        and not rebuilt."""
        plan = object.__new__(SketchPlan)
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            object.__setattr__(plan, f.name, v.to(device)
                               if isinstance(v, torch.Tensor) else v)
        return plan

    @property
    def y(self) -> int:
        return self.bucket.shape[0]

    @property
    def d(self) -> int:
        return self.bucket.shape[1]

    @property
    def rho(self) -> float:
        """Compression ratio D / (Y Z)."""
        return self.d / (self.y * self.z)


def make_plan(d: int, y: int, z: int, seed: int = 0,
              device="cuda") -> SketchPlan:
    """The hash rows drawn by the same numpy calls as the JAX package's
    ``make_plan``, so ``bucket`` and ``sign`` are bit-identical.  A
    ``meta`` plan is built on the CPU and moved."""
    if torch.device(device).type == "meta":
        return make_plan(d, y, z, seed, "cpu").to(device)
    rng = np.random.default_rng(seed)
    bucket = rng.integers(0, z, size=(y, d), dtype=np.int32)
    sign = rng.choice(np.array([-1.0, 1.0], np.float32), size=(y, d))
    return SketchPlan(torch.from_numpy(bucket).to(device),
                      torch.from_numpy(sign).to(device), z)


def selection_matrices(plan: SketchPlan) -> torch.Tensor:
    """Dense signed-selection tensor S (Y, D, Z), S[y,d,z] =
    sign[y,d]·1[bucket[y,d]=z] (tests and yardsticks only)."""
    oh = torch.nn.functional.one_hot(plan.bucket.long(), plan.z)
    return oh.to(torch.float32) * plan.sign[..., None]


def compress(h: torch.Tensor, plan: SketchPlan) -> torch.Tensor:
    """Eq. 20: h (..., D) -> sketch (..., Y, Z), in h's dtype (the wire
    payload)."""
    return kops.sketch_compress(h, plan)


def decompress(u: torch.Tensor, plan: SketchPlan) -> torch.Tensor:
    """Eq. 21: sketch (..., Y, Z) -> estimate (..., D) via median of Y."""
    return kops.sketch_decompress(u, plan)


def _median(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Median along ``axis`` by the compare-exchange network (an even count
    averages the middle two; a min/max tie splits the gradient in halves)."""
    return median_rows(x.unbind(axis))


def channel(h: torch.Tensor, plan: SketchPlan) -> torch.Tensor:
    """compress -> decompress round trip (the lossy channel)."""
    return decompress(compress(h, plan), plan)
