"""Benchmark of the port: counterpart of ``bench.py``.

    python -m mpeg_pcc_tmc13_tpu_torch.bench [--device=cpu]
        [--points N] [--depth D]

Prints ONE JSON line with ``bench.py``'s keys, on its cloud
(``make_surface_cloud(1_000_000, 11)``, 889,682 unique codes, colours
from ``_colors_for``, qp 22), each lane over its counterpart in the
port, in ``bench.py``'s order:

  host lanes (``host_numbers``, ``bench.py:70-148``): geometry with the
  auto (native) engine in PARENT mode, RAHT colour fixed-point and
  float, the OBUF engine;
  device lanes (``device_numbers``, ``bench.py:151-363``): the D2H link
  probe, the occupancy pass, the analysis with its two-step fetch, the
  geometry pipeline's encode and decode over the raw link, the rANS
  engine (its three CUDA kernels on a card), the fixed-point RAHT
  closed loop (``DeviceFpRaht``), the float RAHT forward (block kernel
  B1 on a card) with its Parseval check.

The headline ``device_e2e_roundtrip_throughput`` is N / (geometry
encode + decode + attribute encode + decode), against the 1.0 Mpts/s
CPU tmc3 baseline.  As in ``bench.py``, host keys divide by the point
count n (duplicates included), device keys by the unique count nn.

Where it departs from ``bench.py``:

* no fallback that hides the device (``bench.py:381-384``, and the
  ``rans_error`` / ``device_attr_error`` keys of ``:279``, ``:332``):
  the device is the current CUDA device unless ``--device`` names
  another; without one the run exits non-zero with ``NoDeviceError``'s
  message, and a lane that raises fails the run;
* no compile-cache gate (``bench.py:287-302``): the attribute lane
  always runs;
* clocks: every device lane stops its clock after
  ``torch.cuda.synchronize()`` and a device-to-host copy of its result
  (the float forward: of its root, which every level feeds), and runs
  once untimed first, which takes the kernel build and the CUDA
  context.  ``device_kernel_mpts`` alone, as ``bench.py:193-210``
  defines it, synchronizes without a fetch;
* checks raise: the host geometry and OBUF decodes give the unique
  codes back, the geometry pipeline's decode equals them (``:256``),
  the sorted rANS decode too (``:275``), the attribute decode equals
  the encoder's reconstruction (``device_attr_ok``), and the Parseval
  error is below 1e-3 (``device_numerics_ok``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .bitstream import entropy, hls
from .models import attributes as attr_model
from .models import geometry_obuf
from .models import geometry_octree as go
from .models import geometry_rans
from .models.attr_raht import qp_to_step_q16
from .ops import octree as octree_ops
from .ops import raht_device, raht_fp_device
from .runtime import device_pipeline as dp
from .parallel.dryrun import _check
from .runtime.roundtrip import (_colors_for, _sync, make_surface_cloud,
                                parseval_rel_err, sorted_unique_codes)
from .utils import morton
from .utils.device import NoDeviceError
from .utils.device import resolve as resolve_device

QP = 22
BASELINE_MPTS = 1.0       # reference tmc3, ~1 Mpoint/s single-core
PARSEVAL_MAX = 1e-3
LINK_PROBE_BYTES = 1 << 21


def _timeit(fn, device=None):
    """Wall seconds of ``fn()``, stopped after a synchronize of
    ``device``; ``fn`` ends with its result on the host."""
    t0 = time.perf_counter()
    fn()
    if device is not None:
        _sync(device)
    return time.perf_counter() - t0


def host_numbers(pos, uniq, depth, n):
    """The host engines (``bench.py:70-148``): octree geometry (auto
    engine, PARENT contexts), RAHT colour at the CLI default (fixed
    point, native backend) and the float engine, and the OBUF engine."""
    out = {}
    t_enc = float("inf")
    data = b""
    for _ in range(3):
        enc = entropy.RangeEncoder()
        t0 = time.perf_counter()
        go.encode(pos, depth, enc, go.OctreeContexts(), engine="auto",
                  ctx_mode=octree_ops.CTX_MODE_PARENT, need_order=False)
        data = enc.get_bytes()
        t_enc = min(t_enc, time.perf_counter() - t0)
    t_dec = float("inf")
    for _ in range(3):
        dec = entropy.RangeDecoder(data)
        t0 = time.perf_counter()
        dec_out = go.decode(uniq.shape[0], depth, dec, go.OctreeContexts(),
                            ctx_mode=octree_ops.CTX_MODE_PARENT)
        t_dec = min(t_dec, time.perf_counter() - t0)
    _check(np.array_equal(np.sort(morton.encode(dec_out)), uniq),
           "host geometry decode differs from the input codes")
    out["geom_encode_mpts"] = round(n / t_enc / 1e6, 3)
    out["geom_decode_mpts"] = round(n / t_dec / 1e6, 3)
    out["geom_bpp"] = round(8 * len(data) / n, 3)
    out["_host_rt"] = n / (t_enc + t_dec) / 1e6

    uniq_pos = morton.decode(uniq)
    colors = _colors_for(uniq, depth)
    desc = hls.AttributeDescription(label="color", num_components=3,
                                    bitdepth=8)
    for tag, fixed in (("raht", True), ("raht_float", False)):
        aps = hls.AttributeParameterSet(
            aps_id=0, attr_encoding=hls.AttributeEncoding.RAHT,
            init_qp=QP, raht_fixed_point=fixed)
        t_attr = t_attr_dec = float("inf")
        for _ in range(2 if fixed else 1):
            t0 = time.perf_counter()
            payload = attr_model.encode(colors, uniq_pos, aps, desc,
                                        attr_model.AttributeContexts())
            t_attr = min(t_attr, time.perf_counter() - t0)
            t0 = time.perf_counter()
            rec = attr_model.decode(payload, uniq_pos, aps, desc,
                                    attr_model.AttributeContexts())
            t_attr_dec = min(t_attr_dec, time.perf_counter() - t0)
        _check(rec.shape == colors.shape,
               f"{tag} decoded {rec.shape}, coded {colors.shape}")
        out[f"{tag}_encode_mpts"] = round(uniq.shape[0] / t_attr / 1e6, 3)
        out[f"{tag}_decode_mpts"] = round(
            uniq.shape[0] / t_attr_dec / 1e6, 3)
        if fixed:
            out["raht_bpp"] = round(8 * len(payload) / n, 3)

    gps = hls.GeometryParameterSet(planar_mode_enabled=True)
    t0 = time.perf_counter()
    obuf_payload = geometry_obuf.encode(uniq_pos, depth, None, gps)
    out["obuf_encode_mpts"] = round(
        uniq.shape[0] / (time.perf_counter() - t0) / 1e6, 3)
    t0 = time.perf_counter()
    obuf_out = geometry_obuf.decode(obuf_payload, uniq.shape[0], depth,
                                    None, gps)
    out["obuf_decode_mpts"] = round(
        uniq.shape[0] / (time.perf_counter() - t0) / 1e6, 3)
    _check(np.array_equal(np.unique(morton.encode(obuf_out)), uniq),
           "OBUF decode differs from the input codes")
    out["obuf_bpp"] = round(8 * len(obuf_payload) / n, 3)
    return out


def device_numbers(uniq, depth, device=None):
    """The device lanes (``bench.py:151-363``) on ``device`` (default:
    the current CUDA device; ``NoDeviceError`` without one).  Each lane
    is the best of a few timed calls after an untimed one."""
    device = resolve_device(device)
    nn = uniq.size
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else str(device))}

    # link probe (d2h) over 2 MiB, as bench.py:170-179 defines it: on a
    # card this reads latency more than bandwidth
    probe = torch.zeros(LINK_PROBE_BYTES, dtype=torch.uint8,
                        device=device) ^ 1
    probe.cpu()
    probe2 = probe ^ 2
    _sync(device)
    out["link_d2h_mbps"] = round(
        2.0 / _timeit(lambda: probe2.cpu().numpy()), 1)

    # one tree over the whole frame, codes resident beforehand
    codes_dev = torch.as_tensor(uniq, device=device)
    _sync(device)
    cap = max(64, int(nn * 2.3)) & ~63
    hdr = 4 * depth

    # the occupancy pass, synchronized without a fetch
    def kern():
        octree_ops.encode_occ_u8_hdr(codes_dev, depth, cap)
    _timeit(kern, device)
    t_kern = min(_timeit(kern, device) for _ in range(5))
    out["device_kernel_mpts"] = round(nn / t_kern / 1e6, 1)

    # the same with the counts header, then the bucketed body, fetched
    def analysis():
        o = octree_ops.encode_occ_u8_hdr(codes_dev, depth, cap)
        total = int(o[:hdr].cpu().numpy().view(np.uint32).sum())
        bucket = min(cap, dp._pow2_bucket(total))
        o[hdr:hdr + bucket].cpu().numpy()
    _timeit(analysis, device)
    out["device_analysis_mpts"] = round(
        nn / min(_timeit(analysis, device) for _ in range(5)) / 1e6, 1)

    # geometry encode: analysis, two-step fetch, host entropy
    def geom_enc():
        st = dp.PipelineStats()
        enc = entropy.RangeEncoder()
        t0 = time.perf_counter()
        dp.encode_pipelined(uniq, depth, enc, go.OctreeContexts(),
                            num_slices=1, device_codes=[codes_dev],
                            stats=st, packed_link=False)
        payload = enc.get_bytes()
        _sync(device)
        return time.perf_counter() - t0, st, payload
    geom_enc()
    t_e2e_enc, st_enc, payload = min((geom_enc() for _ in range(4)),
                                     key=lambda r: r[0])
    out["device_e2e_encode_mpts"] = round(nn / t_e2e_enc / 1e6, 3)
    out["host_entropy_mpts"] = round(
        nn / max(st_enc.host_entropy_s, 1e-9) / 1e6, 2)
    out["link_bytes_per_point"] = round(st_enc.link_bytes / nn, 2)
    out["device_busy_fraction"] = round(min(t_kern / t_e2e_enc, 1.0), 4)

    # geometry decode: host entropy, one upload, one expansion, the
    # leaf codes fetched
    def geom_dec():
        (nodes, cnt), = dp.decode_pipelined(
            entropy.RangeDecoder(payload), go.OctreeContexts(), depth, 1,
            nn, device=device)
        return nodes[:int(cnt)].cpu().numpy()
    rec = geom_dec()
    _check(np.array_equal(rec, uniq),
           "device geometry decode differs from the input codes")
    t_e2e_dec = min(_timeit(geom_dec, device) for _ in range(4))
    out["device_e2e_decode_mpts"] = round(nn / t_e2e_dec / 1e6, 3)
    out["_rt"] = nn / (t_e2e_enc + t_e2e_dec) / 1e6

    # the rANS engine: analysis, modelling and coding on the device
    upos = morton.decode(uniq)
    pay = geometry_rans.encode(upos, depth, device=device)
    t_re = min(_timeit(lambda: geometry_rans.encode(upos, depth,
                                                    device=device), device)
               for _ in range(3))
    rout = geometry_rans.decode(pay, nn, depth, device=device)
    _check(np.array_equal(np.sort(morton.encode(rout)), uniq),
           "rANS decode differs from the input codes")
    t_rd = min(_timeit(lambda: geometry_rans.decode(pay, nn, depth,
                                                    device=device), device)
               for _ in range(3))
    out["rans_encode_mpts"] = round(nn / t_re / 1e6, 2)
    out["rans_decode_mpts"] = round(nn / t_rd / 1e6, 2)
    out["rans_bpp"] = round(8 * len(pay) / nn, 3)
    out["rans_rt_mpts"] = round(nn / (t_re + t_rd) / 1e6, 2)

    # fixed-point RAHT colour: the plan staged once, the closed loop on
    # the device, the host range-codes the q rows
    colors = _colors_for(uniq, depth)
    steps = [qp_to_step_q16(QP)] * 3
    t0 = time.perf_counter()
    dfr = raht_fp_device.DeviceFpRaht(uniq, depth, steps, device=device)
    _sync(device)
    out["device_attr_plan_s"] = round(time.perf_counter() - t0, 2)

    def attr_enc():
        enc = entropy.RangeEncoder()
        actx = attr_model.AttributeContexts()
        recon = dfr.encode(colors, lambda q: enc.zrow_residuals(
            actx.zrow, q.astype(np.int32)))
        return enc.get_bytes(), recon
    apayload, recon = attr_enc()
    t_ae = min(_timeit(attr_enc, device) for _ in range(2))
    out["device_attr_encode_mpts"] = round(nn / t_ae / 1e6, 3)
    out["device_attr_bpp"] = round(8 * len(apayload) / nn, 3)

    def attr_dec():
        dec = entropy.RangeDecoder(apayload)
        actx = attr_model.AttributeContexts()
        return dfr.decode(lambda m: dec.zrow_residuals(actx.zrow, m, 3),
                          3).cpu().numpy()
    vals = attr_dec()
    t_ad = min(_timeit(attr_dec, device) for _ in range(2))
    out["device_attr_decode_mpts"] = round(nn / t_ad / 1e6, 3)
    enc_rec = ((recon + raht_fp_device.HALF)
               >> raht_fp_device.F).cpu().numpy()
    out["device_attr_ok"] = bool(vals.shape == colors.shape
                                 and np.array_equal(vals, enc_rec))
    _check(out["device_attr_ok"],
           "attribute decode differs from the encoder's reconstruction")
    out["_full_rt"] = nn / (t_e2e_enc + t_e2e_dec + t_ae + t_ad) / 1e6

    # the float RAHT forward on resident geometry
    fvals = colors.astype(np.float64)
    staged = raht_device.stage_plan(uniq, depth, device)
    vals_d = torch.as_tensor(fvals, dtype=torch.float32, device=device)

    def forward():
        _acs, root = raht_device.forward_device(uniq, vals_d, depth,
                                                staged=staged)
        return root.cpu().numpy()
    forward()
    out["device_raht_mpts"] = round(nn / _timeit(forward, device) / 1e6, 1)

    # numerics on the device: RAHT is orthonormal (Parseval)
    sub = uniq[:1 << 14]
    sub_vals = fvals[:1 << 14].astype(np.float32)
    acs, root = raht_device.forward_device(sub, sub_vals, depth,
                                           device=device)
    rel = parseval_rel_err(
        sub_vals, [(c.cpu().numpy(), m.cpu().numpy()) for c, m in acs],
        root.cpu().numpy())
    out["device_numerics_ok"] = bool(rel < PARSEVAL_MAX)
    out["device_raht_max_rel_err"] = float(round(float(rel), 8))
    _check(out["device_numerics_ok"],
           f"Parseval relative error {rel} >= {PARSEVAL_MAX}")
    return out


def main(argv=None) -> int:
    """Run every lane and print the line; raises ``NoDeviceError``
    before any lane when no device is given and none is present."""
    ap = argparse.ArgumentParser(
        prog="python -m mpeg_pcc_tmc13_tpu_torch.bench",
        description="Prints one JSON line: the port's lanes of bench.py.")
    ap.add_argument("--points", type=int, default=1_000_000,
                    help="points of the surface cloud (default 1,000,000)")
    ap.add_argument("--depth", type=int, default=11,
                    help="octree depth (default 11)")
    ap.add_argument("--device", default=None,
                    help="torch device of the device lanes (default: the "
                         "current CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)     # before any lane runs

    n = args.points
    pos = make_surface_cloud(n, args.depth)
    uniq = sorted_unique_codes(pos)
    host = host_numbers(pos, uniq, args.depth, n)
    dev = device_numbers(uniq, args.depth, device=device)

    dev["device_geom_rt_mpts"] = round(dev.pop("_rt"), 3)
    headline = dev.pop("_full_rt")
    host.pop("_host_rt")
    print(json.dumps({
        "metric": "device_e2e_roundtrip_throughput",
        "value": round(headline, 3),
        "unit": "Mpoints/s",
        "vs_baseline": round(headline / BASELINE_MPTS, 3),
        **host,
        **dev,
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NoDeviceError as e:
        sys.exit(f"bench: {e}")
