"""Frozen copy of halo2_verifier_tpu/utils/serde.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

Byte-stream reader/writer helpers (reference: helpers.rs:104-166).

Integers are big-endian (ReadExt/WriteExt); selector bitmaps pack 8 bools
per byte LSB-first (helpers.rs:104-118).
"""

from __future__ import annotations

import struct


class ByteReader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def read_exact(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise EOFError("unexpected end of buffer")
        out = self._data[self._pos: self._pos + n]
        self._pos += n
        return out

    def read_u8(self) -> int:
        return self.read_exact(1)[0]

    def read_u16(self) -> int:
        return struct.unpack(">H", self.read_exact(2))[0]

    def read_u32(self) -> int:
        return struct.unpack(">I", self.read_exact(4))[0]

    def read_i32(self) -> int:
        return struct.unpack(">i", self.read_exact(4))[0]

    def at_end(self) -> bool:
        return self._pos == len(self._data)

    @property
    def pos(self) -> int:
        return self._pos


class ByteWriter:
    def __init__(self):
        self._out = bytearray()

    def write_all(self, b: bytes) -> None:
        self._out += b

    def write_u8(self, v: int) -> None:
        self._out.append(v & 0xFF)

    def write_u16(self, v: int) -> None:
        self._out += struct.pack(">H", v)

    def write_u32(self, v: int) -> None:
        self._out += struct.pack(">I", v)

    def write_i32(self, v: int) -> None:
        self._out += struct.pack(">i", v)

    def getvalue(self) -> bytes:
        return bytes(self._out)


def pack_bits(bits) -> bytes:
    """Pack bools 8-per-byte, LSB-first (helpers.rs:104-111)."""
    out = bytearray((len(bits) + 7) // 8)
    for i, bit in enumerate(bits):
        if bit:
            out[i >> 3] |= 1 << (i & 7)
    return bytes(out)


def unpack_bits(data: bytes, n: int) -> list[bool]:
    """Unpack n bools from LSB-first packed bytes (helpers.rs:114-118)."""
    return [bool((data[i >> 3] >> (i & 7)) & 1) for i in range(n)]
