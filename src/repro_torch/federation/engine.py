"""Batched federation engine: one local round for a whole cohort of
clients, stacked along a leading client axis.

The counterpart of the JAX package's ``repro/federation/engine.py``, with
the same data layout and the same update:

- clients are bucketed by their ``Split``;
- each bucket's per-client LoRA trees (or one shared tree, broadcast) are
  stacked along a leading client axis, and the ``steps`` local batches of
  every client are padded to ``batch_size`` rows and stacked into
  ``(steps, N, B, S)`` tokens and ``(steps, N, B)`` labels and weights
  (:func:`repro_torch.data.pipeline.stack_padded_batches`), all on the
  device;
- each local step takes every client's ``(loss, grads)`` of
  :func:`~repro_torch.core.split_training.weighted_split_loss` on its row
  of the stacks under its own channel, then updates the stacks as whole
  tensors: the FedProx
  term against the broadcast anchor, a per-client global-norm clip
  (``clip_norm``), and ``p - lr * g`` with the head group's own lr
  (``head_lr``);
- the ``(steps, N)`` losses of every bucket stay on the device until the
  round's end, where one transfer brings them all to the host.

Where the JAX package ``vmap``s the gradient over the client axis and
``scan``s the steps in one compiled function, this engine computes each
client's gradient by autograd through the hand-written kernels, one
client after another.  So it has no use yet for the JAX engine's fixed
cohort shapes: the cohort ladder (``BUCKET_LADDER``, ``bucket_size``),
its zero-weight phantom rows and the stacked SS-OP bases come with the
client axis inside the kernels and a captured graph per (split, bucket)
(ROADMAP.md queue 1 item 3b's next step).  Without phantom rows every
client gets what the JAX engine gives it: there their loss and gradients
are exactly zero and their results are dropped.

:func:`screen_stats` gives the screening stage its per-update delta
statistics (plain tensor arithmetic on the trees' device, as the JAX
package leaves them to XLA, and one transfer to the host).

Not ported: ``mesh=`` (the multi-GPU engine, ROADMAP.md queue 8) raises;
``compile_cache_sizes`` and the engine's gauges and compile counter
wait for the graph capture (ROADMAP.md queue 2 item 11), and the JAX
placement helpers (``placement_platform``, ``donate_buffers``) have
``device`` as their counterpart.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import telemetry as tm
from repro_torch.core.split_training import (Channel, Split, loss_and_grad,
                                             weighted_split_loss)
from repro_torch.data.pipeline import stack_padded_batches
from repro_torch.models.split_api import as_split_model
from repro_torch.optim import adapter_head_lr_tree, fedprox_gradient
from repro_torch.optim.optimizers import tree_leaves, tree_map

PROX_MU = 0.01   # matches the reference path's FedProx weight


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"{item})")


# ---------------------------------------------------------------------------
# stacked-tree helpers
# ---------------------------------------------------------------------------

def is_client_map(theta) -> bool:
    """True when ``theta`` is a {client-id: tree} map (integer keys —
    Python or numpy ints) rather than a single LoRA tree (whose dict
    nodes have string keys)."""
    return isinstance(theta, dict) and bool(theta) and \
        all(isinstance(k, (int, np.integer)) and not isinstance(k, bool)
            for k in theta)


def stack_trees(trees: Sequence):
    """[tree, ...] -> one tree with a leading client axis on every leaf."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def broadcast_tree(tree, n: int):
    """Replicate a tree n times along a new leading client axis (a view)."""
    return tree_map(lambda p: p.unsqueeze(0).expand((n,) + p.shape), tree)


def index_tree(tree, i: int):
    """Client i of a stacked tree (views of the stacked leaves)."""
    return tree_map(lambda a: a[i], tree)


@torch.no_grad()
def screen_stats(base, trees: Sequence, weights: Sequence[float]):
    """Per-update delta statistics for the screening stage: for each
    client update in ``trees`` against the shared dispatch model
    ``base``, whether every leaf is finite, the global delta norm, and
    the cosine against the finite-masked weighted-mean delta of the
    cohort.  Returns numpy ``(finite bool[N], delta_norm f64[N], cos
    f64[N])``, fetched from the device in one transfer (the weights go
    up through pinned memory, so that is the pass's one host sync).

    As in the JAX package, the updates, ``base`` and the weights are cast
    to float32 before the deltas are formed, whatever the trees' type, so
    an x64 run judges its updates on the same f32 statistics.  Each tree
    is flattened into one row, so a pass is a few whole-cohort ops and
    not a few per leaf."""
    f32 = torch.float32

    def flat(tree):
        return torch.cat([x.reshape(-1).to(f32) for x in tree_leaves(tree)])
    deltas = torch.stack([flat(t) for t in trees]) - flat(base)   # (N, P)
    finite = torch.isfinite(deltas)
    fin = finite.all(dim=1)
    norms = torch.sqrt(torch.sum(deltas * deltas, dim=1))
    w = torch.tensor([float(x) for x in weights], dtype=f32)
    if deltas.is_cuda:
        w = w.pin_memory().to(deltas.device, non_blocking=True)
    # the cohort's mean delta over finite updates only (NaN entries zeroed
    # so one poisoned client cannot poison the reference direction)
    wmask = w * fin
    mean = (wmask @ torch.where(finite, deltas, 0.0)) \
        / torch.clamp(wmask.sum(), min=1e-12)
    dot = deltas @ mean
    mnorm = torch.sqrt(torch.sum(mean * mean))
    cos = dot / torch.clamp(norms * mnorm, min=1e-12)
    out = torch.stack([fin.to(f32), norms, cos]).cpu().numpy()
    return (out[0] > 0, out[1].astype(np.float64),
            out[2].astype(np.float64))


def _clip_rows(grads, max_norm: float):
    """``clip_by_global_norm`` of each client's row of a stacked tree: the
    global norm over that row's leaves (f32+ accumulation), one scale a
    row, a no-op under the cap, no 0/0 on an all-zero row."""
    def acc(g):
        return g.to(torch.promote_types(g.dtype, torch.float32))
    sq = sum(torch.sum(torch.square(acc(g)).reshape(g.shape[0], -1), dim=1)
             for g in tree_leaves(grads))
    scale = torch.clamp(max_norm / torch.clamp(torch.sqrt(sq), min=1e-12),
                        max=1.0)

    def scaled(g):
        row = scale.view((-1,) + (1,) * (g.dim() - 1))
        return (acc(g) * row).to(g.dtype)
    return tree_map(scaled, grads)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class BatchedEngine:
    """Executor of one federation's local rounds over stacked clients.

    One instance per :class:`~repro_torch.federation.simulation.Federation`;
    ``run_clients`` has the JAX package's signature and return value.  The
    channels come with each call (``run_clients``' ``channels``), so the
    engine takes no sketch plan and no channel switches."""

    def __init__(self, model, frozen, *, lr: float, batch_size: int,
                 prox_mu: float = PROX_MU, mesh=None,
                 head_lr: Optional[float] = None, clip_norm: float = 0.0,
                 device="cuda"):
        if mesh is not None:
            raise _not_ported("mesh= (the multi-GPU engine)", "queue 8")
        self.model = as_split_model(model)
        self.cfg = self.model.cfg
        self.frozen = frozen
        self.lr = lr
        self.head_lr = head_lr       # None -> lr (single-group legacy)
        self.clip_norm = clip_norm   # 0 -> no per-client gradient clipping
        self.batch_size = batch_size
        self.prox_mu = prox_mu
        self.device = torch.device(device)

    def _upload(self, a: np.ndarray, dtype) -> torch.Tensor:
        """A host array on the device; on a CUDA device through pinned
        memory and an asynchronous copy, so the round does not wait on
        it."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _round(self, split: Split, channels: Sequence[Channel], lora_stack,
               anchor, tokens, labels, weights):
        """One bucket's local round: ``(final stack, (steps, N) losses)``,
        both on the device."""
        model, frozen = self.model, self.frozen
        steps, n = tokens.shape[:2]
        # per-leaf python-float lrs (adapter vs head groups); with
        # head_lr=None every leaf is exactly `lr`
        lrs = adapter_head_lr_tree(lora_stack, self.lr, self.head_lr)
        stack, losses = lora_stack, []
        for s in range(steps):
            grads = []
            for i in range(n):
                batch = {"tokens": tokens[s, i], "labels": labels[s, i],
                         "weights": weights[s, i]}
                lv, g = loss_and_grad(
                    lambda lp: weighted_split_loss(model, frozen, lp, batch,
                                                   split, channels[i]),
                    index_tree(stack, i))
                losses.append(lv)
                grads.append(g)
            with torch.no_grad():
                g = stack_trees(grads)
                if anchor is not None:
                    g = fedprox_gradient(g, stack, anchor, self.prox_mu)
                if self.clip_norm > 0:
                    g = _clip_rows(g, self.clip_norm)
                stack = tree_map(lambda p, gg, lr: p - lr * gg, stack, g,
                                 lrs)
        return stack, torch.stack(losses).reshape(steps, n)

    # -- public API --------------------------------------------------------
    def run_clients(self, theta, clients: Sequence[int],
                    splits: Dict[int, Split], channels: Dict[int, Channel],
                    batches: Dict[int, List[Tuple[np.ndarray, np.ndarray]]],
                    prox_anchor=None,
                    per_client_theta: Optional[bool] = None
                    ) -> Dict[int, Tuple[object, float]]:
        """Run one local round for every client, batched per split bucket.

        ``theta`` is one shared LoRA tree broadcast to every client, or a
        ``{client: tree}`` dict of per-client starting points
        (``per_client_theta``; by default sniffed with
        :func:`is_client_map`).  ``batches[n]`` is the client's pre-drawn
        list of ``steps`` (tokens, labels) batches; ``channels[n]`` its
        channel.  Returns ``{client: (updated lora tree, mean local
        loss)}``; the loss tensors of all buckets reach the host in a
        single transfer."""
        per_client = (is_client_map(theta) if per_client_theta is None
                      else per_client_theta)
        buckets: Dict[Split, List[int]] = {}
        for n in clients:
            buckets.setdefault(splits[n], []).append(n)

        pending = []
        for split, members in buckets.items():
            toks, labs, wts = stack_padded_batches(
                [batches[n] for n in members], self.batch_size)
            lora_stack = (stack_trees([theta[n] for n in members])
                          if per_client
                          else broadcast_tree(theta, len(members)))
            toks = self._upload(toks, torch.int64)
            labs = self._upload(labs, torch.int64)
            wts = self._upload(wts, torch.float32)
            t0 = time.perf_counter()
            out_stack, losses = self._round(
                split, [channels[n] for n in members],
                lora_stack, prox_anchor, toks, labs, wts)
            if tm.enabled():
                tm.observe("engine.dispatch_s", time.perf_counter() - t0)
                tm.inc("engine.clients", len(members))
            pending.append((members, out_stack, losses))

        # one host transfer for every bucket's (steps, N) losses
        flat = torch.cat([l.reshape(-1) for (_, _, l) in pending]).cpu()
        results: Dict[int, Tuple[object, float]] = {}
        at = 0
        for members, out_stack, losses in pending:
            ls = flat[at:at + losses.numel()].reshape(losses.shape).numpy()
            at += losses.numel()
            per_client_loss = ls.mean(axis=0)                # (N,)
            for i, n in enumerate(members):
                results[n] = (index_tree(out_stack, i),
                              float(per_client_loss[i]))
        return results
