"""A pure-Python codec for the subset of MessagePack the checkpoints use.

The JAX package writes its checkpoints with the ``msgpack`` library
(``msgpack.packb(obj, use_bin_type=True)``); the port reads and writes the
same files without it.  The subset: nil, bool, int (up to 64 bits),
float64, str, bin, array and map.  :func:`packb` picks the smallest
encoding of each value, as the library does, so the two give the same
bytes for the same object; :func:`unpackb` also reads float32, which the
library writes only when asked to.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def _pack_int(n: int, out: List[bytes]) -> None:
    if n >= 0:
        if n < 0x80:
            out.append(struct.pack("B", n))
        elif n <= 0xFF:
            out.append(b"\xcc" + struct.pack("B", n))
        elif n <= 0xFFFF:
            out.append(b"\xcd" + struct.pack(">H", n))
        elif n <= 0xFFFFFFFF:
            out.append(b"\xce" + struct.pack(">I", n))
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + struct.pack(">Q", n))
        else:
            raise OverflowError(f"integer {n} does not fit 64 bits")
    elif n >= -32:
        out.append(struct.pack("b", n))
    elif n >= -0x80:
        out.append(b"\xd0" + struct.pack("b", n))
    elif n >= -0x8000:
        out.append(b"\xd1" + struct.pack(">h", n))
    elif n >= -0x80000000:
        out.append(b"\xd2" + struct.pack(">i", n))
    elif n >= -0x8000000000000000:
        out.append(b"\xd3" + struct.pack(">q", n))
    else:
        raise OverflowError(f"integer {n} does not fit 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
              out: List[bytes]) -> None:
    """A length header: a fix code below ``fix_max``, else the 8-bit (if
    ``codes`` has three), 16-bit or 32-bit form."""
    if n < fix_max:
        out.append(struct.pack("B", fix | n))
        return
    widths = ("B", ">H", ">I")[3 - len(codes):]
    for code, fmt in zip(codes, widths):
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(struct.pack("B", code) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} does not fit 32 bits")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        if len(data) < 0x100:
            out.append(b"\xc4" + struct.pack("B", len(data)))
        elif len(data) < 0x10000:
            out.append(b"\xc5" + struct.pack(">H", len(data)))
        else:
            out.append(b"\xc6" + struct.pack(">I", len(data)))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack bytes, each value in its smallest encoding
    (str as str, bytes as bin)."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "at")

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.at = 0

    def take(self, n: int) -> memoryview:
        end = self.at + n
        if end > len(self.buf):
            raise ValueError(f"truncated: wanted {n} bytes at offset "
                             f"{self.at} of {len(self.buf)}")
        out = self.buf[self.at:end]
        self.at = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _read(r: _Reader) -> Any:
    b = r.unpack("B")
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I",
             0xCF: ">Q", 0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        return r.unpack(fixed[b])
    sized = {0xC4: ("B", bytes), 0xC5: (">H", bytes), 0xC6: (">I", bytes),
             0xD9: ("B", str), 0xDA: (">H", str), 0xDB: (">I", str),
             0xDC: (">H", list), 0xDD: (">I", list),
             0xDE: (">H", dict), 0xDF: (">I", dict)}
    if b not in sized:
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x} at "
                         f"offset {r.at - 1}")
    fmt, kind = sized[b]
    n = r.unpack(fmt)
    if kind is bytes:
        return bytes(r.take(n))
    if kind is str:
        return str(r.take(n), "utf-8")
    if kind is list:
        return [_read(r) for _ in range(n)]
    return _read_map(r, n)


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def unpackb(data: bytes) -> Any:
    """The one object ``data`` encodes; ``ValueError`` when it is
    truncated, holds a type outside the subset, or has bytes left over."""
    r = _Reader(data)
    obj = _read(r)
    if r.at != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.at} bytes of extra data after "
                         f"the object")
    return obj
