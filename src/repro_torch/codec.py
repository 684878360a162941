"""A pure-Python MessagePack subset: the workload traces' and the epoch
spill's document codec.

The reference writes its trace chunks and its epoch spill with
``msgpack.packb(doc, use_bin_type=True)`` and reads them with
``msgpack.unpackb(raw=False)``; the port must read and write the same
files on machines that lack ``msgpack``.  This module covers exactly the
types those documents hold: nil, bool, int (-2**63 .. 2**64 - 1), float
(written as float64), str, bytes-like (bin), list and tuple (array) and
dict (map).  ``packb`` gives ``msgpack.packb(obj, use_bin_type=True)``'s
bytes exactly (each int in its smallest format, map entries in insertion
order); ``unpackb`` gives ``msgpack.unpackb(raw=False)``'s objects (arrays
as lists; also float32).  Other types raise ``TypeError`` on packing, as
msgpack does without a ``default`` hook; numpy scalars are not packed
(the documents hold Python numbers).  Extension types are not read.
"""

from __future__ import annotations

import struct

_F64 = struct.Struct(">d")
_F32 = struct.Struct(">f")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out.append(n & 0xFF)
    elif 0 < n <= 0xFF:
        out += b"\xcc" + n.to_bytes(1, "big")
    elif -0x80 <= n < 0:
        out += b"\xd0" + n.to_bytes(1, "big", signed=True)
    elif 0 < n <= 0xFFFF:
        out += b"\xcd" + n.to_bytes(2, "big")
    elif -0x8000 <= n < 0:
        out += b"\xd1" + n.to_bytes(2, "big", signed=True)
    elif 0 < n <= 0xFFFFFFFF:
        out += b"\xce" + n.to_bytes(4, "big")
    elif -0x80000000 <= n < 0:
        out += b"\xd2" + n.to_bytes(4, "big", signed=True)
    elif 0 < n <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + n.to_bytes(8, "big")
    elif -0x8000000000000000 <= n < 0:
        out += b"\xd3" + n.to_bytes(8, "big", signed=True)
    else:
        raise OverflowError(f"integer {n} does not fit MessagePack")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple, out: bytearray) -> None:
    """A container or string header: the fix form below ``fix_max``, else
    the smallest of 8/16/32-bit lengths (``codes``, None where absent)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, width in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise ValueError(f"length {n} does not fit MessagePack")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _F64.pack(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the covered types."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# (struct format, byte count) of the fixed-width scalars, by type byte
_SCALARS = {
    0xCA: (_F32, 4), 0xCB: (_F64, 8),
    0xCC: (struct.Struct(">B"), 1), 0xCD: (struct.Struct(">H"), 2),
    0xCE: (struct.Struct(">I"), 4), 0xCF: (struct.Struct(">Q"), 8),
    0xD0: (struct.Struct(">b"), 1), 0xD1: (struct.Struct(">h"), 2),
    0xD2: (struct.Struct(">i"), 4), 0xD3: (struct.Struct(">q"), 8),
}
# length width of str8/16/32, bin8/16/32, array16/32 and map16/32
_LENGTHS = {0xD9: 1, 0xDA: 2, 0xDB: 4, 0xC4: 1, 0xC5: 2, 0xC6: 4,
            0xDC: 2, 0xDD: 4, 0xDE: 2, 0xDF: 4}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated MessagePack data")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def length(self, width: int) -> int:
        return int.from_bytes(self.take(width), "big")

    def value(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SCALARS:
            fmt, n = _SCALARS[b]
            return fmt.unpack(self.take(n))[0]
        if b in _LENGTHS:
            n = self.length(_LENGTHS[b])
            if b in (0xD9, 0xDA, 0xDB):
                return str(self.take(n), "utf-8")
            if b in (0xC4, 0xC5, 0xC6):
                return bytes(self.take(n))
            if b in (0xDC, 0xDD):
                return [self.value() for _ in range(n)]
            return self.map(n)
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes):
    """``msgpack.unpackb(data, raw=False)`` for the covered types."""
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("extra data after the MessagePack object")
    return obj
