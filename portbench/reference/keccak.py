"""Frozen copy of halo2_verifier_tpu/transcript/keccak.py for the benchmark's plain
reference: pure Python, with the native and accelerator paths taken
out. It imports nothing outside this folder.

Keccak-256 (original Keccak padding 0x01, NOT SHA3's 0x06).

The reference uses the `sha3` crate's `Keccak256` (transcript/mod.rs:7,143),
which is legacy Keccak with rate 136 and padding byte 0x01. hashlib only
ships SHA3 (0x06 padding), so the permutation is implemented here.
"""

from __future__ import annotations


_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rol(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(state: list[int]) -> None:
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [state[x] ^ state[x + 5] ^ state[x + 10] ^ state[x + 15] ^ state[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                state[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(
                    state[x + 5 * y], _ROTATIONS[x][y]
                )
        # chi
        for x in range(5):
            for y in range(5):
                state[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y] & _MASK
                )
        # iota
        state[0] ^= rc


class _PyKeccak256:
    """Incremental legacy-Keccak-256 with a cloneable state (pure Python)."""

    RATE = 136

    def __init__(self):
        self._state = [0] * 25
        self._buf = b""

    def copy(self):
        k = self.__class__.__new__(self.__class__)
        k._state = list(self._state)
        k._buf = self._buf
        return k

    def update(self, data: bytes):
        self._buf += data
        while len(self._buf) >= self.RATE:
            block, self._buf = self._buf[: self.RATE], self._buf[self.RATE:]
            self._absorb(block)
        return self

    def _absorb(self, block: bytes) -> None:
        for i in range(self.RATE // 8):
            self._state[i] ^= int.from_bytes(block[8 * i: 8 * i + 8], "little")
        _keccak_f(self._state)

    def digest(self) -> bytes:
        pad_len = self.RATE - len(self._buf)
        if pad_len == 1:
            padding = b"\x81"
        else:
            padding = b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
        state = list(self._state)
        block = self._buf + padding
        for i in range(self.RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i: 8 * i + 8], "little")
        _keccak_f(state)
        out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
        return out[:32]


Keccak256 = _PyKeccak256
