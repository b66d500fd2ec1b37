"""Carry weights between the JAX package and the port, through numpy.

The JAX package keeps a model's parameters as two trees, ``frozen`` and
``lora``, of nested dicts.  Its layer blocks are stacked for ``lax.scan``:
every leaf under ``"blocks"`` has a leading layer axis.  The port keeps the
same dicts with the same keys and leaf layouts, except that ``"blocks"`` is
a list with one dict per layer.  So the mapping is by path:

- ``frozen[k1][k2]...`` -> ``frozen[k1][k2]...``, the same array;
- ``frozen["blocks"][k1]...[i]`` (layer ``i`` of the stacked leaf) ->
  ``frozen["blocks"][i][k1]...``; likewise for ``lora``.

Non-parametric norms (olmo-1b's ``ln1``/``ln2``/``final_norm``) are empty
dicts and cross as empty dicts; a tied-embedding model has no ``head``.
An MoE model's leading dense layers (deepseek-v2's first layer) are a list
of per-layer dicts under ``"prefix"`` in both packages (the JAX package
unrolls them in front of its scan) and cross as that list; ``"blocks"``
then holds the other ``num_layers - first_dense_layers`` layers.
BERT's leaves outside the block stack (frozen ``pos``, ``seg`` and
``ln_embed``; LoRA ``pooler`` and ``head``) have no layer axis and cross as
they are.
The ELSA channel's parameters (``u``, ``v``, ``bucket``, ``sign``) and an
AdamW state (``step``, and ``m``/``v`` shaped like the LoRA tree) cross the
same way.

bfloat16 numpy arrays (ml_dtypes) cross as their 16-bit patterns, so
nothing is rounded on the way.  The port does not import ml_dtypes: a
bfloat16 tensor crosses to numpy as ``np.dtype("bfloat16")``, which the
JAX package registers with numpy when the process holds both packages (the
only place the bridge is used).
"""
from __future__ import annotations

import numpy as np
import torch


def _to_torch(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.uint16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a copy: JAX arrays are read-only
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _tree_to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device, dtype) for v in tree]
    return _to_torch(tree, device, dtype)


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def _n_layers(tree):
    """The leading (layer) axis of the first array leaf; empty dicts, such
    as a non-parametric norm's, hold none."""
    if isinstance(tree, dict):
        for v in tree.values():
            n = _n_layers(v)
            if n is not None:
                return n
        return None
    return tree.shape[0]


def _from_jax(tree, device, dtype):
    out = {}
    for k, v in tree.items():
        if k == "blocks":
            out[k] = [_tree_to_torch(_unstack(v, i), device, dtype)
                      for i in range(_n_layers(v))]
        else:
            out[k] = _tree_to_torch(v, device, dtype)
    return out


def params_from_jax_numpy(cfg, frozen_np, lora_np, device="cuda", dtype=None):
    """The JAX package's ``frozen``/``lora`` trees (nested dicts of numpy
    arrays, ``blocks`` leaves stacked on a leading layer axis) -> the
    port's ``{"frozen", "lora"}`` parameters on ``device``.  ``dtype``
    casts the floating leaves (None keeps each leaf's own)."""
    n = _n_layers(frozen_np["blocks"])
    n_prefix = cfg.moe.first_dense_layers if cfg.moe else 0
    if n != cfg.num_layers - n_prefix or \
            len(frozen_np.get("prefix", ())) != n_prefix:
        raise ValueError(
            f"{cfg.name}: the tree has {n} stacked layers and "
            f"{len(frozen_np.get('prefix', ()))} prefix layers, the config "
            f"{cfg.num_layers} layers ({n_prefix} of them prefix)")
    return {"frozen": _from_jax(frozen_np, device, dtype),
            "lora": _from_jax(lora_np, device, dtype)}


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def _tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_numpy(v) for v in tree]
    return _to_numpy(tree)


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    if isinstance(layers[0], torch.Tensor):
        return torch.stack(layers)
    return np.stack(layers)


def _to_jax(tree):
    return {k: (_stack([_tree_to_numpy(layer) for layer in v])
                if k == "blocks" else _tree_to_numpy(v))
            for k, v in tree.items()}


def params_to_jax_numpy(params):
    """The inverse of :func:`params_from_jax_numpy`: the port's parameters
    -> ``(frozen_np, lora_np)`` in the JAX package's layout."""
    return _to_jax(params["frozen"]), _to_jax(params["lora"])


def channel_from_jax_numpy(channel_np, device="cuda"):
    """The JAX launcher's ``_channel`` dict (u, v, bucket, sign as numpy
    arrays) -> tensors on ``device`` with the same dtypes."""
    return _tree_to_torch(channel_np, device, None)


def opt_state_from_jax_numpy(state_np, device="cuda"):
    """The JAX package's AdamW state ``{"step", "m", "v"}`` (``m``/``v``
    shaped like its LoRA tree) -> the port's, with ``blocks`` as a list."""
    return {"step": _to_torch(state_np["step"], device, None),
            "m": _from_jax(state_np["m"], device, None),
            "v": _from_jax(state_np["v"], device, None)}


def opt_state_to_jax_numpy(state):
    """The inverse of :func:`opt_state_from_jax_numpy`."""
    return {"step": _to_numpy(state["step"]), "m": _to_jax(state["m"]),
            "v": _to_jax(state["v"])}


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def jax_leaf_order(tree):
    """The leaves of one of the port's parameter trees, listed so that
    their flattened concatenation is ``jax.tree_util.tree_leaves`` of the
    JAX package's tree flattened: dict keys sorted, lists (an MoE model's
    ``prefix``) in order, and each stacked ``blocks`` leaf as its layers in
    turn (layer-major).  The population
    registry lays out its adapter rows this way, so the two packages'
    rows compare element by element."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if k == "blocks" and isinstance(v, list):
            per_layer = [_sorted_leaves(layer) for layer in v]
            out += [layer[j] for j in range(len(per_layer[0]))
                    for layer in per_layer]
        else:
            out += _sorted_leaves(v)
    return out


def stack_blocks(tree):
    """A tree in the port's layout (``"blocks"`` a list of per-layer
    dicts, at any depth) -> the JAX package's (each ``"blocks"`` leaf
    stacked on a leading layer axis); tensors stay tensors."""
    if isinstance(tree, dict):
        return {k: (_stack(v) if k == "blocks"
                    and isinstance(v, list) and v else stack_blocks(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(stack_blocks(v) for v in tree)
    return tree


def unstack_blocks(tree):
    """The inverse of :func:`stack_blocks`; a tree already in the port's
    layout passes through."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            n = _n_layers(v) if k == "blocks" and isinstance(v, dict) \
                else None
            out[k] = ([_unstack(v, i) for i in range(n)] if n is not None
                      else unstack_blocks(v))
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(unstack_blocks(v) for v in tree)
    return tree
