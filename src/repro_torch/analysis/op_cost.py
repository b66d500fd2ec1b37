"""Count a step's work op by op, on any device: the counterpart of the JAX
package's ``repro/analysis/hlo_cost.py``.

An eager program has no HLO to parse, so the count is taken while the
program runs, by one ``TorchDispatchMode`` (:class:`OpCounter`) that sees
every aten op:

- **FLOPs** are the matmul-class ops' (the formulas of
  ``torch.utils.flop_counter``'s registry: mm, bmm, addmm, baddbmm,
  convolutions) plus the operations the hand-written kernels declare
  (:mod:`repro_torch.kernels._cost`); elementwise ops count none.
- **Bytes** are each aten op's operands and results, each at the smaller
  of its own bytes and its storage's (a broadcast reads its storage, a
  slice its elements), since eager moves them through HBM; a gather
  (an embedding lookup) reads only the rows it gathers, as ``hlo_cost``'s
  fusion bytes read only a gathered parameter's slices.  Factory and
  metadata ops count 0 bytes, as ``hlo_cost._ZERO_BYTES`` do, and views
  (by their schema) are not counted at all.  A kernel call counts the
  bytes it declares and none of the aten ops run inside it.
- **The peak** (the counterpart of ``memory_analysis``) is the live
  storage bytes over the run: a storage is registered when an op first
  gives it and dropped by ``weakref.finalize`` when it is freed; the
  tensors that exist before (weights, optimizer state, inputs) are
  registered at the start.

On ``meta`` nothing is allocated or computed, so a full-width step counts
in host seconds; the CPU and the card count the same step the same.
Every figure is per device (one device until ROADMAP.md queue 1 item 8):
``collective_bytes`` stays empty.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _cost

aten = torch.ops.aten

FLOPS_COUNTED = ("the matmul-class aten ops (torch.utils.flop_counter's "
                 "registry) plus the hand-written kernels' declared "
                 "operations; elementwise ops count none")

# ops that move no bytes (views are found by their schema; factory ops as
# ops with no tensor operand, or by these names)
_ZERO_BYTES = {aten._unsafe_view, aten._local_scalar_dense, aten.lift_fresh,
               aten.detach,
               aten.alias, aten.sym_size, aten.sym_stride, aten.sym_numel,
               aten.sym_storage_offset, aten.is_same_size, aten.is_nonzero,
               aten.empty_like, aten.zeros_like, aten.ones_like,
               aten.full_like, aten.new_empty, aten.new_empty_strided,
               aten.new_zeros, aten.new_ones, aten.new_full}

# ops that read only the rows they gather from their first operand
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}

_SHORT = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
          torch.float64: "f64", torch.int64: "i64", torch.int32: "i32",
          torch.bool: "bool"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] = self.collective_bytes.get(k, 0.0) \
                + v * mult

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _op_tensors(values):
    """The tensors among an aten op's arguments or results (a tensor, or a
    list or tuple of them, each)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(x for x in v if isinstance(x, torch.Tensor))
    return out


_KERNEL_KEYS = tuple(getattr(torch._C.DispatchKey, k) for k in (
    "CPU", "CUDA", "Meta", "CompositeExplicitAutograd",
    "CompositeExplicitAutogradNonFunctional"))


@functools.lru_cache(maxsize=None)
def _composite(func) -> bool:
    """Whether ``func`` is only a composite of other ops (no kernel of its
    own for a device): ``silu_backward``, say, has both, and runs as its
    own kernel."""
    return func.has_kernel_for_dispatch_key(
        torch._C.DispatchKey.CompositeImplicitAutograd) and not any(
        func.has_kernel_for_dispatch_key(k) for k in _KERNEL_KEYS)


def _nbytes(t: torch.Tensor) -> int:
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _short(x) -> str:
    if isinstance(x, torch.dtype):
        return _SHORT.get(x, str(x).removeprefix("torch."))
    return str(x)


def _add(table, key, flops, nbytes, calls=1):
    row = table.get(key)
    if row is None:
        table[key] = [calls, flops, nbytes]
    else:
        row[0] += calls
        row[1] += flops
        row[2] += nbytes


@dataclasses.dataclass
class Count:
    """What one counted run gave: its :class:`Cost`, each kernel's
    ``[calls, flops, bytes]``, the per-op rows ``{(op or kernel, shape):
    [calls, flops, bytes]}`` and the peak of live bytes."""
    cost: Cost
    kernels: Dict[str, List[float]]
    rows: Dict[Tuple[str, str], List[float]]
    peak_bytes: int

    def extrapolate(self, other: "Count", steps: float) -> "Count":
        """This count plus ``steps`` times what ``other``, the same run with
        one more repeat of its repeated part (a microbatch), adds: exact
        where each repeat runs the same ops.  The peak is this run's."""
        def line(a, b):
            return a + steps * (b - a)

        def lines(ta, tb):
            return {k: [line(x, y) for x, y in zip(ta.get(k, [0, 0, 0]),
                                                    tb.get(k, [0, 0, 0]))]
                    for k in {**ta, **tb}}
        coll = {k: line(self.cost.collective_bytes.get(k, 0.0), v)
                for k, v in other.cost.collective_bytes.items()}
        cost = Cost(line(self.cost.flops, other.cost.flops),
                    line(self.cost.bytes, other.cost.bytes), coll)
        return Count(cost, lines(self.kernels, other.kernels),
                     lines(self.rows, other.rows), self.peak_bytes)

    def op_rows(self) -> List[dict]:
        """The rows as ``{"name", "shape", "calls", "flops", "bytes"}``,
        most bytes first."""
        out = [dict(name=k[0], shape=k[1], calls=v[0], flops=v[1],
                    bytes=v[2]) for k, v in self.rows.items()]
        return sorted(out, key=lambda r: -r["bytes"])


class OpCounter(TorchDispatchMode):
    """Counts every aten op run while it is entered, and takes the kernels'
    declared work (see the module's docstring).  ``track``: a tree (dicts,
    lists, tuples, dataclasses) of the tensors that exist before the run
    and count towards its peak.  :meth:`result` gives the :class:`Count`."""

    def __init__(self, track=()):
        super().__init__()
        self.cost = Cost()
        self.kernels: Dict[str, List[float]] = {}
        self._rows: Dict[tuple, List[float]] = {}
        self.depth = 0             # > 0 inside a kernel call
        self._entered = 0
        self._live: Dict[int, weakref.finalize] = {}
        self._lock = threading.Lock()
        self.live_bytes = self.peak_bytes = 0
        for t in _tensors(track):
            self._track(t)

    # -- the peak ------------------------------------------------------------
    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key, n = st._cdata, st.nbytes()
        with self._lock:
            if not n or key in self._live:
                return
            self._live[key] = weakref.finalize(st, self._free, key, n)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int, n: int):
        with self._lock:
            if self._live.pop(key, None) is not None:
                self.live_bytes -= n

    # -- the count -----------------------------------------------------------
    @contextlib.contextmanager
    def kernel_call(self, kernel: str, shape: tuple, flops, nbytes):
        """One call of a hand-written kernel: its declared work is counted,
        the aten ops inside it are not."""
        _add(self.kernels, kernel, flops, nbytes)
        _add(self._rows, (kernel, shape), flops, nbytes)
        self.cost.flops += flops
        self.cost.bytes += nbytes
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # under inference mode composite ops (einsum, matmul, ...) reach
            # the mode whole: count the ops they decompose into
            with self:
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        if func.is_view:                 # no storage, no flops, no bytes
            return out
        outs = _op_tensors(out if isinstance(out, (list, tuple)) else (out,))
        for t in outs:
            self._track(t)
        if self.depth:
            return out
        ins = _op_tensors(args) + _op_tensors(kwargs.values())
        packet = func._overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        nbytes = 0
        if ins and not func.is_view and packet not in _ZERO_BYTES:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            if packet in _GATHERS:       # the rows gathered, not the table
                nbytes += sum(map(_nbytes, outs)) - _nbytes(ins[0])
        key = (func, tuple((t.dtype, tuple(t.shape)) for t in ins))
        _add(self._rows, key, flops, nbytes)
        self.cost.flops += flops
        self.cost.bytes += nbytes
        return out

    def __enter__(self):
        if not self._entered:
            _cost.ACTIVE.append(self)
        self._entered += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._entered -= 1             # re-entered to decompose an op
            if not self._entered:
                _cost.ACTIVE.remove(self)
                with self._lock:
                    for f in self._live.values():
                        f.detach()
                    self._live.clear()

    def result(self) -> Count:
        rows: Dict[Tuple[str, str], List[float]] = {}
        for (name, shape), (calls, flops, nbytes) in self._rows.items():
            if isinstance(name, str):        # a kernel: its declared shape
                key = (name, "(" + ", ".join(map(_short, shape)) + ")")
            else:
                key = (str(name), " ".join(
                    f"{_short(dt)}[{','.join(map(str, s))}]"
                    for dt, s in shape))
            _add(rows, key, flops, nbytes, calls)
        return Count(dataclasses.replace(self.cost, collective_bytes=dict(
            self.cost.collective_bytes)),
            {k: list(v) for k, v in self.kernels.items()}, rows,
            self.peak_bytes)


def count(fn, *args):
    """``fn(*args)`` under an :class:`OpCounter` that tracks ``args`` from
    the start: ``(Count, fn's result)``."""
    with OpCounter(track=args) as counter:
        out = fn(*args)
    return counter.result(), out
