"""The system under test: one frame through the port's device path.

The only module of the benchmark that imports the program
(``mpeg_pcc_tmc13_tpu_torch``), and only inside ``PortCodec``.  An
encode side is

1. geometry: upload the sorted unique Morton codes, then
   ``runtime/device_pipeline.encode_pipelined`` (one slice, raw link)
   into a ``bitstream/entropy.RangeEncoder``: the occupancy kernel, the
   two-step fetch and the native host range coder;
2. attributes (where the traffic codes them): ``ops/raht_fp_device.
   DeviceFpRaht`` on the frame's codes (the host planner and the plan's
   staging), then its ``encode``, whose q rows the harness zrow-codes in
   its own ``emit``;

and a decode side is

3. geometry: ``decode_pipelined`` (host range decode, upload, the
   expansion kernels) and the fetch of the leaf codes;
4. attributes: a ``DeviceFpRaht`` on the *decoded* codes, its ``decode``
   fed by the harness's ``read_q``, and the fetch of the values.

Each side ends with ``torch.cuda.synchronize()`` after a host copy of
its result, inside its span.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from .spans import Clock


@dataclass
class Encoded:
    geom: bytes
    attr: bytes
    q_rows: List[np.ndarray]
    recon: object                     # (N, C) int64 Q13 tensor, or None


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

        self.torch = torch
        self.entropy = entropy
        self.AttributeContexts = AttributeContexts
        self.OctreeContexts = OctreeContexts
        self.fp = raht_fp_device
        self.dp = device_pipeline
        self.depth = depth
        self.steps = list(steps)
        self.channels = channels
        self.attributes = attributes
        self.device = torch.device(device)
        self.clock = clock

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def encode(self, codes: np.ndarray, values: np.ndarray) -> Encoded:
        clock, ent = self.clock, self.entropy
        with clock.span("encode"):
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
        with clock.span("decode"):
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


def device_description(device, chips: int) -> dict:
    """The result's ``device``; the peak is the caching allocator's."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
