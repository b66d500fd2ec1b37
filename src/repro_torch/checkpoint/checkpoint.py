"""Pytree checkpointing in the JAX package's MessagePack format (atomic
writes, dtype and shape preserved).

Wire format (version 2), that of the JAX package's
``repro/checkpoint/checkpoint.py``, so each package's ``restore`` reads
the other's files:

- array leaves (torch tensors, numpy arrays and numpy scalars) are
  encoded as ``{"__nd__": True, dtype, shape, data}`` with the numpy
  ``dtype.name``; a tensor is copied to the host first, and a
  ``bfloat16`` tensor (no numpy dtype here) is written as ``"bfloat16"``
  with its raw 2-byte data;
- python primitives (``None``/``bool``/``int``/``float``/``str``) pass
  through natively, so a float leaf comes back as a float;
- a tuple node is wrapped as ``{"__tuple__": [items]}``, so ``restore``
  returns the same tree structure that was saved.

``restore`` gives every leaf back as a numpy array, except ``bfloat16``
leaves, which come back as ``torch.bfloat16`` CPU tensors.  The bytes are
packed by :mod:`repro_torch.checkpoint.wire`, which picks each value's
smallest encoding as the ``msgpack`` library does: for a tree of numpy
arrays and primitives, :func:`save` writes the same bytes as the JAX
package's ``save``.

``save_state``/``restore_state`` add a format marker + version and
validate the payload on load: a truncated file, a stale pre-versioned
checkpoint, or a payload missing its required sections fails with a
clear ``ValueError``.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import wire

#: Format marker + version written by :func:`save_state`.
STATE_FORMAT = "repro-state"
STATE_VERSION = 2

_ND = "__nd__"
_TUPLE = "__tuple__"
_PRIMITIVES = (bool, int, float, str)


def _leaf_bytes(x) -> Tuple[str, List[int], bytes]:
    """``(dtype name, shape, raw bytes)`` of an array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return ("bfloat16", list(t.shape),
                    t.view(torch.int16).numpy().tobytes())
        x = t.numpy()
    arr = np.asarray(x)
    if arr.dtype == object:
        raise TypeError(f"cannot checkpoint object-dtype leaf {x!r}")
    return arr.dtype.name, list(arr.shape), arr.tobytes()


def _encode_leaf(x):
    name, shape, data = _leaf_bytes(x)
    return {_ND: True, "dtype": name, "shape": shape, "data": data}


def _is_encoded(obj):
    return isinstance(obj, dict) and obj.get(_ND, False)


def _decode_leaf(obj):
    if obj["dtype"] == "bfloat16":
        bits = np.frombuffer(obj["data"], dtype=np.int16)
        return torch.from_numpy(bits.reshape(obj["shape"]).copy()
                                ).view(torch.bfloat16)
    arr = np.frombuffer(obj["data"], dtype=np.dtype(obj["dtype"]))
    return arr.reshape(obj["shape"]).copy()


def _to_wire(tree):
    if isinstance(tree, dict):
        return {k: _to_wire(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {_TUPLE: [_to_wire(v) for v in tree]}
    if isinstance(tree, list):
        return [_to_wire(v) for v in tree]
    if tree is None or isinstance(tree, _PRIMITIVES):
        return tree
    return _encode_leaf(tree)


def _from_wire(obj):
    if isinstance(obj, dict):
        if _is_encoded(obj):
            return _decode_leaf(obj)
        if _TUPLE in obj and len(obj) == 1:
            return tuple(_from_wire(v) for v in obj[_TUPLE])
        return {(k.decode() if isinstance(k, bytes) else k): _from_wire(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_wire(v) for v in obj]
    return obj


def save(path: str, tree: Any) -> None:
    """Atomically write ``tree`` to ``path`` (write-temp + rename, so a
    crash mid-write never leaves a truncated checkpoint in place)."""
    payload = wire.packb(_to_wire(tree))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def restore(path: str) -> Any:
    """Load a pytree written by :func:`save` (or by the JAX package's).
    Raises ``ValueError`` with a clear message when the file is truncated
    or not a checkpoint."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        wire_obj = wire.unpackb(raw)
    except ValueError as e:                   # truncated / not a checkpoint
        raise ValueError(
            f"checkpoint {path!r} is corrupt or truncated "
            f"({len(raw)} bytes): {e}") from e
    return _from_wire(wire_obj)


def save_state(path: str, *, params=None, opt_state=None,
               step: int = 0, extra: Dict = None) -> None:
    save(path, {"__format__": STATE_FORMAT,
                "__version__": STATE_VERSION,
                "params": params, "opt_state": opt_state,
                "step": int(step), "extra": extra or {}})


def restore_state(path: str):
    """Load + validate a :func:`save_state` checkpoint.

    Raises ``ValueError`` when the file is truncated, predates the
    format-version field (stale), comes from an incompatible version,
    or is missing a required section.
    """
    state = restore(path)
    if not isinstance(state, dict) or "__format__" not in state:
        raise ValueError(
            f"checkpoint {path!r} has no format marker — it is either "
            "stale (written before format versioning) or not a "
            "save_state checkpoint; re-save it with the current code")
    if state["__format__"] != STATE_FORMAT:
        raise ValueError(
            f"checkpoint {path!r} has format {state['__format__']!r}, "
            f"expected {STATE_FORMAT!r}")
    if state["__version__"] != STATE_VERSION:
        raise ValueError(
            f"checkpoint {path!r} has format version "
            f"{state['__version__']}, this code reads version "
            f"{STATE_VERSION}; re-save it with the matching code")
    missing = [k for k in ("params", "opt_state", "step", "extra")
               if k not in state]
    if missing:
        raise ValueError(
            f"checkpoint {path!r} is missing sections {missing} — "
            "the payload was corrupted after the header")
    return state


def _same_structure(a, b, leaves_a: List, leaves_b: List) -> bool:
    """Walk two trees in step, collecting their leaves; False where the
    structures differ (dict keys, list against tuple, None)."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) \
                or sorted(a) != sorted(b):
            return False
        return all(_same_structure(a[k], b[k], leaves_a, leaves_b)
                   for k in sorted(a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            return False
        return all(_same_structure(x, y, leaves_a, leaves_b)
                   for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    leaves_a.append(a)
    leaves_b.append(b)
    return True


def tree_equal(a, b) -> bool:
    """Exact equality of two trees: the same structure (tuple-vs-list and
    dict keys included), the same leaf dtypes, shapes and bits; a tensor
    leaf on any device compares by its host copy."""
    la: List = []
    lb: List = []
    if not _same_structure(a, b, la, lb):
        return False
    return all(_leaf_bytes(x) == _leaf_bytes(y) for x, y in zip(la, lb))
