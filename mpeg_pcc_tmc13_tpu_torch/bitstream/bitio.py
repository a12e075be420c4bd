"""Bit-oriented reader/writer for high-level syntax payloads.

Mirrors the contract of the reference's BitWriter.h:44-77 / BitReader.h:
MSB-first bit packing, ``u(n)`` fixed-width codes, ``ue(v)`` unsigned
Exp-Golomb, ``se(v)`` signed Exp-Golomb, and byte alignment. Used for
SPS/GPS/APS/GBH/ABH serialisation (bitstream/hls.py).
"""

from __future__ import annotations


class BitWriter:
    def __init__(self):
        self._buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int):
        """u(n): write nbits of value, MSB first."""
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        self._acc = (self._acc << nbits) | value
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self._buf.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_bit(self, b: int):
        self.write(1 if b else 0, 1)

    def write_ue(self, v: int):
        """ue(v): Exp-Golomb. Codeword: M zeros, 1, M info bits of v+1."""
        assert v >= 0
        x = v + 1
        nbits = x.bit_length()
        self.write(0, nbits - 1)
        self.write(x, nbits)

    def write_se(self, v: int):
        """se(v): signed Exp-Golomb (positive -> odd mapping)."""
        self.write_ue((v << 1) - 1 if v > 0 else (-v) << 1)

    def byte_align(self, bit: int = 0):
        if self._nbits:
            pad = 8 - self._nbits
            self.write((1 << pad) - 1 if bit else 0, pad)

    def get_bytes(self) -> bytes:
        assert self._nbits == 0, "call byte_align() before get_bytes()"
        return bytes(self._buf)


class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self._data = data
        self._pos = pos
        self._acc = 0
        self._nbits = 0

    def read(self, nbits: int) -> int:
        while self._nbits < nbits:
            if self._pos >= len(self._data):
                # Permissive past-the-end zero fill, like BitReader.h's
                # behaviour on truncated payloads.
                self._acc <<= 8
            else:
                self._acc = (self._acc << 8) | self._data[self._pos]
                self._pos += 1
            self._nbits += 8
        self._nbits -= nbits
        v = (self._acc >> self._nbits) & ((1 << nbits) - 1)
        self._acc &= (1 << self._nbits) - 1
        return v

    def read_bit(self) -> int:
        return self.read(1)

    def read_ue(self) -> int:
        nzeros = 0
        while self.read(1) == 0:
            nzeros += 1
            if nzeros > 64:
                raise ValueError("corrupt ue(v)")
        return ((1 << nzeros) | self.read(nzeros)) - 1 if nzeros else 0

    def read_se(self) -> int:
        u = self.read_ue()
        return (u + 1) >> 1 if (u & 1) else -(u >> 1)

    def byte_align(self):
        self._nbits = 0
        self._acc = 0

    @property
    def byte_pos(self) -> int:
        return self._pos
