"""The default codec: one slice a frame through the port's device path.

An encode side is

1. geometry: upload the sorted unique Morton codes, then
   ``runtime/device_pipeline.encode_pipelined`` (one slice, raw link)
   into a ``bitstream/entropy.RangeEncoder``: the occupancy kernel, the
   two-step fetch and the native host range coder;
2. attributes (where the traffic codes them): ``ops/raht_fp_device.
   DeviceFpRaht`` on the frame's codes (on a card the codes' upload and
   the card planner ``build_plan``; on the CPU the host ``build_fp_plan``
   and the plan's upload), then its ``encode``, whose q rows the harness
   zrow-codes in its own ``emit``;

and a decode side is

3. geometry: ``decode_pipelined`` (host range decode and level counting,
   upload, the expansion kernels) and the fetch of the leaf codes;
4. attributes: a ``DeviceFpRaht`` on the *decoded* codes, its ``decode``
   fed by the harness's ``read_q``, and the fetch of the values.

Each side ends with ``torch.cuda.synchronize()`` after a host copy of
its result, inside its span.  The configuration gives the depth
(``bits``), the channels and the quantiser (``qp``); it must state one
slice.  In a traced run each side also installs the port's tracer
(``utils/timing.tracing``) with the frame's ``Record`` as the sink, so
the port's own stages land in the record as ``<side>.<stage>``;
untraced runs install nothing.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import List

import numpy as np

from pccbench.codec import Encoded
from pccbench.frames import step_q16
from pccbench.spans import Clock

# the port's stages that a traced run records (utils/timing.py spans in
# runtime/device_pipeline.py), scoped by the side
PROGRAM_STAGES = ("encode.geom.fetch", "encode.geom.redo",
                  "encode.geom.entropy", "decode.geom.entropy",
                  "decode.geom.count")
SPAN_NAMES = ("encode.geom", "decode.geom", "encode.attr_plan",
              "decode.attr_plan", "encode.attr_loop",
              "decode.attr_loop") + PROGRAM_STAGES


def make(cfg: dict, mix, devices, clock: Clock) -> "PortCodec":
    slices = int(cfg.get("slices", 1))
    if slices != 1:
        raise ValueError(f"the codec octree_raht_fp codes one slice a "
                         f"frame; the configuration states {slices}: name "
                         f"a codec that reads \"slices\"")
    nc = int(cfg["channels"])
    return PortCodec(int(cfg["bits"]), [step_q16(int(cfg["qp"]))] * nc, nc,
                     mix.attributes, devices[0], clock)


class PortCodec:
    def __init__(self, depth: int, steps: List[int], channels: int,
                 attributes: bool, device, clock: Clock):
        import torch
        from mpeg_pcc_tmc13_tpu_torch.bitstream import entropy
        from mpeg_pcc_tmc13_tpu_torch.models.attributes import \
            AttributeContexts
        from mpeg_pcc_tmc13_tpu_torch.models.geometry_octree import \
            OctreeContexts
        from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device
        from mpeg_pcc_tmc13_tpu_torch.runtime import device_pipeline
        from mpeg_pcc_tmc13_tpu_torch.utils import timing

        self.torch = torch
        self.entropy = entropy
        self.AttributeContexts = AttributeContexts
        self.OctreeContexts = OctreeContexts
        self.fp = raht_fp_device
        self.dp = device_pipeline
        self.timing = timing
        self.depth = depth
        self.steps = list(steps)
        self.channels = channels
        self.attributes = attributes
        self.device = torch.device(device)
        self.clock = clock

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _program(self, side: str):
        """The port's tracer into the frame's record, in traced runs."""
        if not self.clock.traced or self.clock.record is None:
            return nullcontext()
        return self.timing.tracing(self.clock.record, side)

    def encode(self, codes: np.ndarray, values: np.ndarray) -> Encoded:
        clock, ent = self.clock, self.entropy
        with clock.span("encode"), self._program("encode"):
            with clock.span("encode.geom"):
                codes_dev = self.torch.as_tensor(codes, device=self.device)
                enc = ent.RangeEncoder()
                stats = self.dp.PipelineStats()
                self.dp.encode_pipelined(
                    codes, self.depth, enc, self.OctreeContexts(),
                    num_slices=1, packed_link=False,
                    device_codes=[codes_dev], stats=stats)
                geom = enc.get_bytes()
            if clock.record is not None:
                clock.record.add("encode.geom_entropy", stats.host_entropy_s)
            attr, q_rows, recon = b"", [], None
            if self.attributes:
                with clock.span("encode.attr_plan"):
                    coder = self.fp.DeviceFpRaht(codes, self.depth,
                                                 self.steps,
                                                 device=self.device)
                aenc = ent.RangeEncoder()
                actx = self.AttributeContexts()

                def emit(q):
                    q_rows.append(q)
                    aenc.zrow_residuals(actx.zrow, q.astype(np.int32))

                with clock.span("encode.attr_loop"):
                    recon = coder.encode(values,
                                         clock.timed("encode.emit", emit))
                    attr = aenc.get_bytes()
                del coder
            self._sync()
        return Encoded(geom, attr, q_rows, recon)

    def decode(self, geom: bytes, attr: bytes, points: int):
        """The decoded (codes, values or None), both host arrays."""
        clock, ent = self.clock, self.entropy
        with clock.span("decode"), self._program("decode"):
            with clock.span("decode.geom"):
                dec = ent.RangeDecoder(geom)
                stats = self.dp.PipelineStats()
                (nodes, cnt), = self.dp.decode_pipelined(
                    dec, self.OctreeContexts(), self.depth, 1, points,
                    stats=stats, device=self.device)
                codes = nodes[:int(cnt)].cpu().numpy()
            if clock.record is not None:
                clock.record.add("decode.geom_entropy", stats.host_entropy_s)
            values = None
            if self.attributes:
                with clock.span("decode.attr_plan"):
                    coder = self.fp.DeviceFpRaht(codes, self.depth,
                                                 self.steps,
                                                 device=self.device)
                adec = ent.RangeDecoder(attr)
                dctx = self.AttributeContexts()
                nc = self.channels

                def read_q(m):
                    return adec.zrow_residuals(dctx.zrow, m, nc)

                with clock.span("decode.attr_loop"):
                    values = coder.decode(
                        clock.timed("decode.read_q", read_q), nc
                    ).cpu().numpy()
                del coder
            self._sync()
        return codes, values
