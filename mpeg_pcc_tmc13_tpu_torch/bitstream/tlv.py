"""TLV stream framing: 1-byte payload type + 4-byte big-endian length +
payload bytes per data unit (reference io_tlv.cpp:writeTlv/readTlv,
payload types hls.h:49-61)."""

from __future__ import annotations

import enum
import struct
from typing import BinaryIO, Iterator, Optional


class PayloadType(enum.IntEnum):
    """Data-unit types (reference hls.h:49-61)."""

    SEQUENCE_PARAMETER_SET = 0
    GEOMETRY_PARAMETER_SET = 1
    GEOMETRY_BRICK = 2
    ATTRIBUTE_PARAMETER_SET = 3
    ATTRIBUTE_BRICK = 4
    TILE_INVENTORY = 5
    FRAME_BOUNDARY_MARKER = 6
    CONSTANT_ATTRIBUTE = 7
    USER_DATA = 8
    DEFAULT_ATTRIBUTE = 9
    ATTR_PARAM_INVENTORY = 10


class PayloadBuffer:
    """A typed payload (reference PayloadBuffer.h)."""

    __slots__ = ("type", "data")

    def __init__(self, type: PayloadType, data: bytes = b""):
        self.type = PayloadType(type)
        self.data = data

    def __len__(self):
        return len(self.data)


def write_tlv(buf: PayloadBuffer, f: BinaryIO):
    f.write(struct.pack(">BI", int(buf.type), len(buf.data)))
    f.write(buf.data)


def read_tlv(f: BinaryIO) -> Optional[PayloadBuffer]:
    hdr = f.read(5)
    if len(hdr) < 5:
        return None
    t, n = struct.unpack(">BI", hdr)
    data = f.read(n)
    if len(data) < n:
        raise EOFError("truncated TLV payload")
    return PayloadBuffer(PayloadType(t), data)


def iter_tlv(f: BinaryIO) -> Iterator[PayloadBuffer]:
    while True:
        buf = read_tlv(f)
        if buf is None:
            return
        yield buf
