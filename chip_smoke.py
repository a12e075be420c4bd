#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (``mpeg_pcc_tmc13_tpu_torch``) once on
``cuda:0`` at the bench size, one phase per printed line:

  (a) device identity: torch's device name and nvidia-smi's name and
      power limit (the nvidia-smi line is printed on its own),
  (b) build of the hand-written CUDA kernels from ``csrc/`` with nvcc,
  (c) each kernel against its plain PyTorch version on the card,
  (d) the device round trip at the bench size (1M-point surface cloud,
      depth 11, qp 22): geometry encode/decode, fixed-point RAHT colour
      encode/decode, the float RAHT lane, each checked against its
      reference, with the kernels' launch counts from this run,
  (e) a depth-21 geometry round trip (the 63-bit Morton domain),
  (f) timing: the stage times of a second (warm) round trip, and each
      kernel against its plain version at the level shapes of (d).

Then one JSON line with the kernels and, last, the result line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero; without CUDA it exits non-zero before any phase.
It imports no jax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

BENCH_POINTS = 1_000_000
BENCH_DEPTH = 11
BENCH_QP = 22
DEEP_POINTS = 200_000
DEEP_DEPTH = 21
CHECK_BLOCKS = 300_001          # not a multiple of any tile
KERNEL_RTOL = 1e-5              # of max(1, max|ref|)
PARSEVAL_MAX = 1e-3
TIMING_REPS = 10

KERNELS = {
    "fwd_blocks": ("raht_fwd_blocks",
                   "mpeg_pcc_tmc13_tpu/ops/pallas_raht.py:48"),
    "inv_blocks": ("raht_inv_blocks",
                   "mpeg_pcc_tmc13_tpu/ops/pallas_raht.py:140"),
}


def _line(tag, **kv):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _block_inputs(nblocks, nchan, seed, device):
    """(B, 8, C) float32 values N(0, 50) and (B, 8) integer weights
    1..64 on occupied slots, 0 elsewhere; the first 256 blocks take
    every occupancy pattern."""
    import torch
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, 256, nblocks)
    pat[:256] = np.arange(256)
    occ = ((pat[:, None] >> np.arange(8)) & 1).astype(bool)
    w = np.where(occ, rng.integers(1, 65, (nblocks, 8)), 0)
    v = rng.normal(0, 50, (nblocks, 8, nchan))
    return (torch.as_tensor(v, dtype=torch.float32, device=device),
            torch.as_tensor(w, dtype=torch.float32, device=device))


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rel_tol(ref):
    return KERNEL_RTOL * max(1.0, float(ref.abs().max()))


def phase_c(device):
    """Each kernel against its plain version on the same CUDA inputs."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import raht_blocks as rb
    errs = {"fwd_blocks": 0.0, "inv_blocks": 0.0}
    for nchan in (1, 3):
        v, w = _block_inputs(CHECK_BLOCKS, nchan, nchan, device)
        coeffs, wout, mask = rb.fwd_blocks(v, w)
        rc, rw, rm = rb.fwd_blocks_ref(v, w)
        _sync(device)
        _check(torch.equal(mask, rm), f"fwd mask differs (C={nchan})")
        _check(torch.equal(wout, rw), f"fwd wout differs (C={nchan})")
        e = float((coeffs - rc).abs().max())
        _check(e <= _rel_tol(rc), f"fwd coeffs off by {e} (C={nchan})")
        errs["fwd_blocks"] = max(errs["fwd_blocks"], e)

        back = rb.inv_blocks(rc, w)
        rback = rb.inv_blocks_ref(rc, w)
        _sync(device)
        e = float((back - rback).abs().max())
        _check(e <= _rel_tol(rback), f"inv children off by {e} (C={nchan})")
        errs["inv_blocks"] = max(errs["inv_blocks"], e)
        _line("c", C=nchan, blocks=CHECK_BLOCKS, mask_wout="identical",
              fwd_max_abs_err=errs["fwd_blocks"],
              inv_max_abs_err=errs["inv_blocks"],
              tol=f"{KERNEL_RTOL}*max(1,max|ref|)")
    return errs


def bench_cloud(n=BENCH_POINTS, depth=BENCH_DEPTH):
    from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt
    uniq = rt.sorted_unique_codes(rt.make_surface_cloud(n, depth))
    return uniq, rt._colors_for(uniq, depth)


def phase_d(device, uniq, depth, colors, qp=BENCH_QP):
    """The slice at the bench size, every stage held to its reference."""
    from mpeg_pcc_tmc13_tpu.bitstream import entropy
    from mpeg_pcc_tmc13_tpu.ops import raht_fp
    from mpeg_pcc_tmc13_tpu_torch.models.attr_raht import qp_to_step_q16
    from mpeg_pcc_tmc13_tpu_torch.models.geometry_octree import \
        OctreeContexts
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_blocks as rb
    from mpeg_pcc_tmc13_tpu_torch.runtime import device_pipeline as dp
    from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt

    rb.reset_launch_counts()
    r = rt.device_roundtrip(uniq, depth, colors, qp=qp, device=device)
    launches = dict(rb.LAUNCHES)

    # geometry: the same port code on CPU tensors gives the same stream
    enc = entropy.RangeEncoder()
    dp.encode_pipelined(uniq, depth, enc, OctreeContexts(), num_slices=1,
                        device="cpu")
    _check(enc.get_bytes() == r.geom_payload,
           "geometry stream differs from the CPU run")
    _check(np.array_equal(r.decoded_codes, uniq),
           "decoded leaf codes differ from the input")

    # fixed-point RAHT: q rows and decoded values equal the numpy spec
    step = qp_to_step_q16(qp)
    ncomp = colors.shape[1]
    t0 = time.perf_counter()
    spec_q = []
    raht_fp.forward_predicted_fp(
        uniq, colors, depth, lambda c, tag: step,
        emit=lambda q, tag: spec_q.append(np.asarray(q, np.int32)))
    _check(len(spec_q) == len(r.q_rows)
           and all(np.array_equal(a, b) for a, b in zip(spec_q, r.q_rows)),
           "fixed-point q rows differ from raht_fp.forward_predicted_fp")
    it = iter(spec_q)
    spec_dec = raht_fp.inverse_predicted_fp(
        uniq, depth, lambda m, tag: next(it).astype(np.int64),
        lambda c, tag: step, ncomp)
    spec_s = time.perf_counter() - t0
    _check(np.array_equal(spec_dec, r.decoded_colors),
           "decoded colours differ from raht_fp.inverse_predicted_fp")

    # float RAHT lane: orthonormal (Parseval) and invertible
    rel = rt.parseval_rel_err(colors, r.raht_acs, r.raht_root)
    _check(rel < PARSEVAL_MAX, f"Parseval relative error {rel}")
    recon_err = float(np.abs(r.raht_recon - colors).max())
    _check(recon_err < 0.5, f"float RAHT inverse off by {recon_err}")
    _check(all(launches[k] > 0 for k in KERNELS),
           f"a kernel was not launched on the main path: {launches}")

    nrows = sum(q.shape[0] for q in r.q_rows)
    _line("d", points=uniq.size, depth=depth, qp=qp,
          geom_bytes=len(r.geom_payload), geom_vs_cpu="identical",
          decoded_codes="identical", attr_bytes=len(r.attr_payload),
          q_rows=nrows, q_rows_vs_spec="identical",
          colors_vs_spec="identical", spec_points=uniq.size,
          spec_s=f"{spec_s:.1f}", parseval_rel_err=rel,
          float_inverse_max_abs_err=recon_err,
          launches=json.dumps(launches, separators=(",", ":")))
    _line("d", stage_s=json.dumps(r.stage_s, separators=(",", ":")))
    return r, launches


def phase_e(device, n=DEEP_POINTS, depth=DEEP_DEPTH):
    """Depth 21: occupancy bytes equal the numpy level builder, and the
    pipeline round trip is exact."""
    import torch

    from mpeg_pcc_tmc13_tpu.bitstream import entropy
    from mpeg_pcc_tmc13_tpu_torch.models.geometry_octree import \
        OctreeContexts
    from mpeg_pcc_tmc13_tpu_torch.ops import octree
    from mpeg_pcc_tmc13_tpu_torch.runtime import device_pipeline as dp
    from mpeg_pcc_tmc13_tpu_torch.utils import morton

    rng = np.random.default_rng(21)
    uniq = np.unique(morton.encode(
        rng.integers(0, 1 << depth, (n, 3), dtype=np.int64)))
    ref = np.concatenate([lv["occ"] for lv in
                          octree.build_levels_np(uniq, depth)])
    occ, counts = octree.encode_occ_u8(torch.as_tensor(uniq, device=device),
                                       depth, ref.size + 64)
    total = int(counts.sum())
    _check(total == ref.size, "depth-21 node count differs")
    _check(np.array_equal(occ[:total].cpu().numpy(), ref),
           "depth-21 occupancy bytes differ from build_levels_np")

    enc = entropy.RangeEncoder()
    dp.encode_pipelined(uniq, depth, enc, OctreeContexts(), num_slices=1,
                        device=device)
    dec = entropy.RangeDecoder(enc.get_bytes())
    (nodes, cnt), = dp.decode_pipelined(dec, OctreeContexts(), depth, 1,
                                        uniq.size, device=device)
    _check(np.array_equal(nodes[:int(cnt)].cpu().numpy(), uniq),
           "depth-21 round trip is not exact")
    _line("e", points=uniq.size, depth=depth, nodes=total,
          bytes_vs_build_levels_np="identical", roundtrip="exact")


def _level_inputs(uniq, colors, depth, device):
    """The (B, 8, C) / (B, 8) inputs of every level of the float lane of
    (d), propagated with the plain version (no kernel launches)."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import raht_blocks as rb
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_device
    vals = torch.as_tensor(colors, dtype=torch.float32, device=device)
    w = torch.ones(vals.shape[0], dtype=torch.float32, device=device)
    fwd, inv = [], []
    for g in raht_device.stage_plan(uniq, depth, device):
        occ = g >= 0
        gi = g.clamp(min=0)
        bv = torch.where(occ[..., None], vals[gi], 0.0)
        bw = torch.where(occ, w[gi], 0.0)
        coeffs, wout, _ = rb.fwd_blocks_ref(bv, bw)
        fwd.append((bv, bw))
        inv.append((coeffs, bw))
        vals, w = coeffs[:, 0, :], wout[:, 0]
    return fwd, inv


def _time_ms(fn, inputs):
    """ms of one pass of fn over every level's inputs, CUDA events over
    TIMING_REPS passes after a warm-up pass."""
    import torch
    for a in inputs:
        fn(*a)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMING_REPS):
        for a in inputs:
            fn(*a)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / TIMING_REPS


def phase_f(device, uniq, depth, colors):
    """Informational timing: stage times of a warm round trip, and each
    kernel against its plain version at the level shapes of (d), in
    turns plain, kernel, kernel, plain."""
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_blocks as rb
    from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt

    r = rt.device_roundtrip(uniq, depth, colors, qp=BENCH_QP, device=device)
    _line("f", warm_stage_s=json.dumps(
        {k: round(v, 6) for k, v in r.stage_s.items()},
        separators=(",", ":")),
        host_entropy_s=r.geom_stats.host_entropy_s,
        link_bytes=r.geom_stats.link_bytes)
    fwd, inv = _level_inputs(uniq, colors, depth, device)
    times = {}
    for name, kern, ref, inputs in (
            ("fwd_blocks", rb.fwd_blocks, rb.fwd_blocks_ref, fwd),
            ("inv_blocks", rb.inv_blocks, rb.inv_blocks_ref, inv)):
        p1 = _time_ms(ref, inputs)
        k1 = _time_ms(kern, inputs)
        k2 = _time_ms(kern, inputs)
        p2 = _time_ms(ref, inputs)
        times[name] = (min(k1, k2), min(p1, p2))
        _line("f", kernel=name, levels=len(inputs),
              blocks=sum(a[0].shape[0] for a in inputs),
              kernel_ms=f"{k1:.4f},{k2:.4f}",
              plain_ms=f"{p1:.4f},{p2:.4f}")
    return times


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs only on a CUDA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)

    from mpeg_pcc_tmc13_tpu.bitstream import entropy
    from mpeg_pcc_tmc13_tpu_torch.ops import _kernels
    if entropy._LIB is None:
        raise RuntimeError("the native entropy library did not build")

    # (a) device identity
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _line("a", torch_device=repr(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    # (b) kernel build from the sources in this checkout
    so, secs = _kernels.build()
    _kernels.load()
    _line("b", library=so.name, nvcc_s=f"{secs:.1f}",
          flags=" ".join(_kernels.NVCC_FLAGS).replace(" ", "_"))

    errs = phase_c(device)                                     # (c)
    uniq, colors = bench_cloud()
    _, launches = phase_d(device, uniq, BENCH_DEPTH, colors)   # (d)
    phase_e(device)                                            # (e)
    times = phase_f(device, uniq, BENCH_DEPTH, colors)         # (f)

    kernels = []
    for key, (name, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mpeg_pcc_tmc13_tpu_torch/csrc/raht_blocks.cu",
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": errs[key], "ms": times[key][0],
            "plain_ms": times[key][1]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
