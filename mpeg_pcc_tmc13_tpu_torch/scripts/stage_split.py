"""Split the bench headline's slow stages into host and device time on a
CUDA card.

    python mpeg_pcc_tmc13_tpu_torch/scripts/stage_split.py [--root DIR]
        [--points N] [--depth D] [--reps R]

On the bench's cloud (``make_surface_cloud(1_000_000, 11)``, 889,682
unique codes, colours from ``_colors_for``, qp 22) it times, best of
``--reps`` after an untimed call, the three stages of
``python -m mpeg_pcc_tmc13_tpu_torch.bench``'s headline that mix host
and device work, each ending in a device-to-host copy of its result:

* geometry decode (``device_pipeline.decode_pipelined``): the host range
  decode (``PipelineStats.host_entropy_s``) against the rest (the
  upload, the per-level expansion, the fetch of the leaf codes);
* attribute encode (``DeviceFpRaht.encode`` with the zrow range coder
  in ``emit``): the host zrow coding against the rest (the device loop
  and its one fetch);
* attribute decode (``DeviceFpRaht.decode``): the host zrow decoding in
  ``read_q`` against the rest (the one upload, the device loop, the
  fetch).

Then one more run of each under ``torch.profiler``: the device-busy time
(the sum of the traced device operations; one stream, so they do not
overlap), the number of device operations, and the five longest.  The
module-level ``LAUNCHES`` counts of ``ops.octree`` and
``ops.raht_fp_device`` over the timed runs are printed where those
modules have them.

``--root`` imports the package from another checkout (for example the
parent commit unpacked into a git-ignored directory), so two versions
are compared by the same script in one call.  Prints one JSON line with
the card's name and power limit.  Needs a CUDA card (exits 1
without) unless ``--device=cpu`` rehearses it, without the profile.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def _best(fn, reps):
    fn()
    return min((fn() for _ in range(reps)), key=lambda r: r[0])


def _profiled(fn, sync):
    """(device-busy ms, device ops, five longest ops) of one ``fn()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    ops = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = ops.get(e.name, (0, 0.0))
            ops[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not ops:
        raise RuntimeError("torch.profiler traced no device operation")
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:5]
    return (round(sum(us for _, us in ops.values()) / 1e3, 4),
            sum(n for n, _ in ops.values()),
            [[name[:60], n, round(us / 1e3, 4)] for name, (n, us) in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--depth", type=int, default=11)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda:0",
                    help="cpu rehearses the control flow (no profile)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("stage_split: no CUDA device", file=sys.stderr)
        return 1
    from mpeg_pcc_tmc13_tpu_torch.bitstream import entropy
    from mpeg_pcc_tmc13_tpu_torch.models.attr_raht import qp_to_step_q16
    from mpeg_pcc_tmc13_tpu_torch.models.attributes import \
        AttributeContexts
    from mpeg_pcc_tmc13_tpu_torch.models.geometry_octree import \
        OctreeContexts
    from mpeg_pcc_tmc13_tpu_torch.ops import octree, raht_fp_device
    from mpeg_pcc_tmc13_tpu_torch.runtime import device_pipeline as dp
    from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    depth = args.depth
    uniq = rt.sorted_unique_codes(rt.make_surface_cloud(args.points, depth))
    colors = rt._colors_for(uniq, depth)
    n = uniq.size
    codes_dev = torch.as_tensor(uniq, device=device)
    enc = entropy.RangeEncoder()
    dp.encode_pipelined(uniq, depth, enc, OctreeContexts(), num_slices=1,
                        device_codes=[codes_dev])
    payload = enc.get_bytes()
    out = {"points": int(n), "depth": depth, "reps": args.reps,
           "root": str(Path(args.root).resolve().name)}

    def geom_dec():
        st = dp.PipelineStats()
        sync()
        t0 = time.perf_counter()
        (nodes, cnt), = dp.decode_pipelined(
            entropy.RangeDecoder(payload), OctreeContexts(), depth, 1, n,
            stats=st, device=device)
        codes = nodes[:int(cnt)].cpu().numpy()
        t = time.perf_counter() - t0
        if not np.array_equal(codes, uniq):
            raise AssertionError("geometry decode differs from the input")
        return t, st.host_entropy_s

    steps = [qp_to_step_q16(22)] * colors.shape[1]
    dfr = raht_fp_device.DeviceFpRaht(uniq, depth, steps, device=device)
    coded = {}

    def attr_enc():
        aenc = entropy.RangeEncoder()
        actx = AttributeContexts()
        host = [0.0]

        def emit(q):
            th = time.perf_counter()
            aenc.zrow_residuals(actx.zrow, q.astype(np.int32))
            host[0] += time.perf_counter() - th
        sync()
        t0 = time.perf_counter()
        recon = dfr.encode(colors, emit)
        coded["payload"] = aenc.get_bytes()
        t = time.perf_counter() - t0
        coded["recon"] = recon
        return t, host[0]

    def attr_dec():
        adec = entropy.RangeDecoder(coded["payload"])
        actx = AttributeContexts()
        host = [0.0]

        def read_q(m):
            th = time.perf_counter()
            rows = adec.zrow_residuals(actx.zrow, m, colors.shape[1])
            host[0] += time.perf_counter() - th
            return rows
        sync()
        t0 = time.perf_counter()
        vals = dfr.decode(read_q, colors.shape[1]).cpu().numpy()
        t = time.perf_counter() - t0
        want = ((coded["recon"] + raht_fp_device.HALF)
                >> raht_fp_device.F).cpu().numpy()
        if not np.array_equal(vals, want):
            raise AssertionError("attribute decode differs from the "
                                 "encoder's reconstruction")
        return t, host[0]

    for mod in (octree, raht_fp_device):
        for k in getattr(mod, "LAUNCHES", {}):
            mod.LAUNCHES[k] = 0
    for name, fn in (("geom_decode", geom_dec), ("attr_encode", attr_enc),
                     ("attr_decode", attr_dec)):
        t, host_s = _best(fn, args.reps)
        out[f"{name}_s"] = round(t, 6)
        out[f"{name}_host_s"] = round(host_s, 6)
        out[f"{name}_rest_s"] = round(t - host_s, 6)
    launches = {}
    for mod in (octree, raht_fp_device):
        launches.update(getattr(mod, "LAUNCHES", {}))
    out["launches_over_timed_runs"] = launches
    for name, fn in (("geom_decode", geom_dec), ("attr_encode", attr_enc),
                     ("attr_decode", attr_dec)) * (device.type == "cuda"):
        busy, nops, top = _profiled(fn, sync)
        out[f"{name}_device_busy_ms"] = busy
        out[f"{name}_device_ops"] = nops
        out[f"{name}_top_ops"] = top
    out["attr_bytes"] = len(coded["payload"])
    out["device"] = str(device)
    if device.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
