"""``tmc3-cuda`` itself, in process: the port's CLI path for a frame.

The configuration's ``cli_options`` are the argv a user gives
``tmc3-cuda`` (an ``encoder.cfg`` as options); ``make`` turns them, and
``--device=<the cell's first device>``, into the CLI's ``Config`` with
``runtime/cli.parse_command_line``, so every option left out keeps the
CLI's default.  Then, as ``cli.encode_sequence`` and
``cli.decode_sequence`` code a sequence, but frame by frame and into
memory:

1. encode: ``encode.input`` turns the sorted codes and values into a
   ``PointCloud``; a new ``runtime/encoder.FrameEncoder`` (every frame
   intra, and its stream whole: parameter sets and bricks)
   ``compress``es and ``flush``es it into TLV units.  ``Encoded.attr``
   is the attribute bricks' units, ``Encoded.geom`` every other unit,
   5-byte TLV headers included, so ``bpp`` counts the stream a user
   stores;
2. decode: a ``runtime/decoder.FrameDecoder`` ``decompress``es the
   units in stream order and is ``flush``ed; ``decode.output`` turns its
   cloud into sorted leaf codes and the values in their order.

PLY reading and writing, which the CLI keeps outside its own clock, are
left out.  Each side ends with ``torch.cuda.synchronize()`` after its
results are on the host, inside its span.  In a traced run each side
installs the port's tracer (``utils/timing.tracing``) with the frame's
``Record`` as the sink, so the CLI path's own stages land in the record
as ``<side>.<stage>``; untraced runs install nothing.  A frame the
encoder splits into more than one slice is refused: the decode feeds
the geometry units before the attribute bricks.

The configuration asks for ``--geomEngine=device``.  A port that codes
the first frame (set-up's warm frame) with nothing allocated on a CUDA
device has ignored it, and ran the whole frame on the host: the codec
raises ``DeviceUnused`` there, so the run ends in set-up with no result
rather than measuring a host-only path under this configuration's name.
"""

from __future__ import annotations

import io
from contextlib import nullcontext

import numpy as np

from pccbench.codec import Encoded
from pccbench.spans import Clock

# the port's stages that a traced run records (utils/timing.py spans in
# runtime/encoder.py and runtime/decoder.py), scoped by the side
PROGRAM_STAGES = ("encode.frame.prepare", "encode.geom.brick",
                  "decode.geom.brick", "encode.attr.brick",
                  "decode.attr.brick")
SPAN_NAMES = ("encode.input", "decode.output") + PROGRAM_STAGES


class DeviceUnused(RuntimeError):
    """The port coded a frame of this configuration without its card."""


def make(cfg: dict, mix, devices, clock: Clock) -> "CliCodec":
    from mpeg_pcc_tmc13_tpu_torch.runtime import cli
    argv = list(cfg["cli_options"]) + [f"--device={devices[0]}"]
    return CliCodec(cli.parse_command_line(argv), devices[0], clock)


class CliCodec:
    def __init__(self, config, device, clock: Clock):
        import torch
        from mpeg_pcc_tmc13_tpu_torch.bitstream import tlv
        from mpeg_pcc_tmc13_tpu_torch.models.pointcloud import PointCloud
        from mpeg_pcc_tmc13_tpu_torch.runtime.decoder import FrameDecoder
        from mpeg_pcc_tmc13_tpu_torch.runtime.encoder import FrameEncoder
        from mpeg_pcc_tmc13_tpu_torch.utils import morton, timing

        self.torch, self.tlv, self.morton, self.timing = \
            torch, tlv, morton, timing
        self.PointCloud = PointCloud
        self.FrameEncoder, self.FrameDecoder = FrameEncoder, FrameDecoder
        self.config = config
        self.device = torch.device(device)
        self.clock = clock
        self.card_seen = self.device.type != "cuda"

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _require_card(self):
        """Once, after the first encode: the card held something."""
        if self.card_seen:
            return
        if self.torch.cuda.max_memory_allocated(self.device) == 0:
            raise DeviceUnused(
                f"--geomEngine=device left {self.device} unused: this port "
                f"codes the configuration's bricks on the host alone")
        self.card_seen = True

    def _program(self, side: str):
        """The port's tracer into the frame's record, in traced runs."""
        if not self.clock.traced or self.clock.record is None:
            return nullcontext()
        return self.timing.tracing(self.clock.record, side)

    def encode(self, codes: np.ndarray, values: np.ndarray) -> Encoded:
        clock, tlv = self.clock, self.tlv
        with clock.span("encode"), self._program("encode"):
            with clock.span("encode.input"):
                cloud = self.PointCloud(self.morton.decode(codes), values,
                                        None)
            units = []
            enc = self.FrameEncoder(self.config.params)
            enc.compress(cloud, units.append)
            enc.flush(units.append)
            bricks = sum(u.type == tlv.PayloadType.GEOMETRY_BRICK
                         for u in units)
            if bricks != 1:
                raise ValueError(f"the codec tmc3_cli codes one slice a "
                                 f"frame; the encoder made {bricks}")
            geom, attr = io.BytesIO(), io.BytesIO()
            for u in units:
                tlv.write_tlv(u, attr if u.type
                              == tlv.PayloadType.ATTRIBUTE_BRICK else geom)
            self._sync()
        self._require_card()
        return Encoded(geom.getvalue(), attr.getvalue(), [], None)

    def decode(self, geom: bytes, attr: bytes, points: int):
        """The decoded (codes, values or None), both host arrays."""
        clock, cfg = self.clock, self.config
        with clock.span("decode"), self._program("decode"):
            frames = []
            dec = self.FrameDecoder(frames.append,
                                    skip_layers=cfg.skip_octree_layers,
                                    max_points=cfg.decode_max_points,
                                    max_lod_levels=cfg.max_lod_levels,
                                    device=cfg.params.device)
            for data in (geom, attr):
                for buf in self.tlv.iter_tlv(io.BytesIO(data)):
                    dec.decompress(buf)
            dec.flush()
            with clock.span("decode.output"):
                cloud, = frames
                codes = self.morton.encode(cloud.positions.astype(np.int64))
                order = np.argsort(codes, kind="stable")
                values = (None if cloud.colors is None
                          else np.asarray(cloud.colors)[order])
                codes = codes[order]
            self._sync()
        return codes, values
