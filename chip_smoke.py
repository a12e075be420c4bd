#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (``mpeg_pcc_tmc13_tpu_torch``) once on
``cuda:0`` at the bench size, one phase per printed line:

  (a) device identity: torch's device name and nvidia-smi's name and
      power limit (the nvidia-smi line is printed on its own),
  (b) build of the port's native host library from ``native/`` with g++
      (its path and build seconds) and of the hand-written CUDA kernels
      from ``csrc/`` with nvcc,
  (c) each block kernel against its plain PyTorch version on the card,
      bit for bit, at ragged batch sizes and all 256 occupancy patterns,
  (d) the device round trip at the bench size (1M-point surface cloud,
      depth 11, qp 22): geometry encode/decode, fixed-point RAHT colour
      encode/decode, the float RAHT lane, each checked against its
      reference, with the kernels' launch counts from this run; first,
      the entry points called without a device run on ``cuda:0``,
  (e) a depth-21 geometry round trip (the 63-bit Morton domain),
  (g) the rANS brick at the bench size through ``models.geometry_rans``
      (the three rANS lane kernels), its payload held to the plain
      versions on the card, each kernel held to its plain version at
      the shapes of this run, and its size beside (d)'s range-coded
      stream,
  (h) a depth-21 rANS round trip, its analysis held to the numpy level
      builder,
  (i) ``models.geometry_octree.encode(engine="device")`` at the bench
      size in NEIGH and PARENT mode, byte-identical to the shared C++
      engine, and decoded back,
  (j) the packed device->host link, the same stream as the raw link,
  (k) the port's tmc3-compatible CLI (``runtime.cli``) on the bench
      cloud with RAHT colour (qp 22): an encode and a decode with each of
      ``--geomEngine=native|device|rans`` on the default CUDA device, the
      rANS stream decoded again in a separate CLI process; the device
      stream equals the native one, every decode gives the unique input
      positions and the same colours, the device engine analysed on the
      card and every rANS kernel launched,
  (f) timing: the stage times of a second (warm) round trip, and each
      kernel against its plain version at the shapes of (d) and (g):
      the pass through the wrappers (CUDA events), its device time (the
      pass replayed as a CUDA graph), the largest level alone for the
      block kernels, and each kernel's bound; plus the rANS
      encode/decode wall times.

Then one JSON line with the kernels and, last, the result line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero; without CUDA it exits non-zero before any phase.
It imports no jax.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

BENCH_POINTS = 1_000_000
BENCH_DEPTH = 11
BENCH_QP = 22
DEEP_POINTS = 200_000
DEEP_DEPTH = 21
CHECK_BLOCKS = (1, 3, 31, 300_001)   # ragged against warps and tiles
PARSEVAL_MAX = 1e-3
TIMING_REPS = 10
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
FP32_FLOPS_PER_S = 67e12        # fp32 outside the tensor cores

SLOW_REPS = 2                   # plain rANS passes take ~1 s each
REPO = Path(__file__).resolve().parent
CLI_DIR = REPO / "build" / "chip_smoke_cli"      # git-ignored
CLI_FLAGS = ("--attribute=color", "--transformType=0", f"--qp={BENCH_QP}")

KERNELS = {
    "fwd_blocks": ("raht_fwd_blocks", "raht_blocks.cu",
                   "mpeg_pcc_tmc13_tpu/ops/pallas_raht.py:48"),
    "inv_blocks": ("raht_inv_blocks", "raht_blocks.cu",
                   "mpeg_pcc_tmc13_tpu/ops/pallas_raht.py:140"),
    "quantize_tables": ("rans_quantize_tables", "rans_lanes.cu",
                        "mpeg_pcc_tmc13_tpu/ops/octree_rans.py:144"),
    "encode_emit": ("rans_encode_emit", "rans_lanes.cu",
                    "mpeg_pcc_tmc13_tpu/ops/octree_rans.py:264"),
    "decode_tiles": ("rans_decode_tiles", "rans_lanes.cu",
                     "mpeg_pcc_tmc13_tpu/ops/octree_rans.py:353"),
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
    pat[:256] = np.arange(min(nblocks, 256))
    occ = ((pat[:, None] >> np.arange(8)) & 1).astype(bool)
    w = np.where(occ, rng.integers(1, 65, (nblocks, 8)), 0)
    v = rng.normal(0, 50, (nblocks, 8, nchan))
    return (torch.as_tensor(v, dtype=torch.float32, device=device),
            torch.as_tensor(w, dtype=torch.float32, device=device))


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_c(device):
    """Each block kernel against its plain version on the same CUDA
    inputs, bit for bit, at ragged batch sizes (a partial warp and a
    partial thread block), for reflectance and colour."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import raht_blocks as rb
    errs = {"fwd_blocks": 0.0, "inv_blocks": 0.0}
    shapes = [(b, c) for c in (1, 3) for b in CHECK_BLOCKS]
    for nblocks, nchan in shapes:
        v, w = _block_inputs(nblocks, nchan, nblocks + nchan, device)
        coeffs, wout, mask = rb.fwd_blocks(v, w)
        rc, rw, rm = rb.fwd_blocks_ref(v, w)
        _sync(device)
        _check(torch.equal(mask, rm), f"fwd mask differs (B={nblocks}, "
               f"C={nchan})")
        _check(torch.equal(wout, rw), f"fwd wout differs (B={nblocks}, "
               f"C={nchan})")
        e_fwd = float((coeffs - rc).abs().max())
        back = rb.inv_blocks(rc, w)
        rback = rb.inv_blocks_ref(rc, w)
        _sync(device)
        e_inv = float((back - rback).abs().max())
        _check(e_fwd == 0.0 and e_inv == 0.0,
               f"a block kernel differs from its plain version (B={nblocks}"
               f", C={nchan}): fwd {e_fwd}, inv {e_inv}")
        errs["fwd_blocks"] = max(errs["fwd_blocks"], e_fwd)
        errs["inv_blocks"] = max(errs["inv_blocks"], e_inv)
    _line("c", shapes=",".join(f"{b}x{c}" for b, c in shapes),
          patterns=256, mask_wout="identical",
          fwd_max_abs_err=errs["fwd_blocks"],
          inv_max_abs_err=errs["inv_blocks"], tol=0)
    return errs


def bench_cloud(n=BENCH_POINTS, depth=BENCH_DEPTH):
    from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt
    uniq = rt.sorted_unique_codes(rt.make_surface_cloud(n, depth))
    return uniq, rt._colors_for(uniq, depth)


def _default_device_check(device):
    """The entry points called without ``device`` run on the current
    CUDA device (a small cloud; before (d)'s counted run)."""
    from mpeg_pcc_tmc13_tpu_torch import host
    from mpeg_pcc_tmc13_tpu_torch.models.geometry_octree import \
        OctreeContexts
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_device, raht_fp_device
    from mpeg_pcc_tmc13_tpu_torch.runtime import device_pipeline as dp
    from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt
    depth = 8
    uniq, colors = bench_cloud(n=20_000, depth=depth)
    r = rt.device_roundtrip(uniq, depth, colors)
    enc = host.RangeEncoder()
    dp.encode_pipelined(uniq, depth, enc, OctreeContexts(), num_slices=1)
    (nodes, cnt), = dp.decode_pipelined(host.RangeDecoder(enc.get_bytes()),
                                        OctreeContexts(), depth, 1,
                                        uniq.size)
    acs, root = raht_device.forward_device(uniq, colors, depth)
    back = raht_device.inverse_device(uniq, acs, root, depth)
    fp = raht_fp_device.DeviceFpRaht(uniq, depth, [1 << 16] * 3)
    devices = {nodes.device, root.device, back.device, fp.device}
    _check(devices == {device} and all(r.launches.values())
           and np.array_equal(nodes[:int(cnt)].cpu().numpy(), uniq)
           and np.array_equal(r.decoded_codes, uniq),
           f"an entry point without device= ran on {devices} "
           f"(launches {r.launches}), not {device}")
    _line("d", default_device=str(device), entry_points=5,
          points=uniq.size)


def phase_d(device, uniq, depth, colors, qp=BENCH_QP):
    """The slice at the bench size, every stage held to its reference."""
    from mpeg_pcc_tmc13_tpu_torch import host
    from mpeg_pcc_tmc13_tpu_torch.models.attr_raht import qp_to_step_q16
    from mpeg_pcc_tmc13_tpu_torch.models.geometry_octree import \
        OctreeContexts
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_blocks as rb
    from mpeg_pcc_tmc13_tpu_torch.runtime import device_pipeline as dp
    from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt

    _default_device_check(device)
    rb.reset_launch_counts()
    r = rt.device_roundtrip(uniq, depth, colors, qp=qp, device=device)
    launches = dict(rb.LAUNCHES)

    # geometry: the same port code on CPU tensors gives the same stream
    enc = host.RangeEncoder()
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
    host.forward_predicted_fp(
        uniq, colors, depth, lambda c, tag: step,
        emit=lambda q, tag: spec_q.append(np.asarray(q, np.int32)))
    _check(len(spec_q) == len(r.q_rows)
           and all(np.array_equal(a, b) for a, b in zip(spec_q, r.q_rows)),
           "fixed-point q rows differ from forward_predicted_fp")
    it = iter(spec_q)
    spec_dec = host.inverse_predicted_fp(
        uniq, depth, lambda m, tag: next(it).astype(np.int64),
        lambda c, tag: step, ncomp)
    spec_s = time.perf_counter() - t0
    _check(np.array_equal(spec_dec, r.decoded_colors),
           "decoded colours differ from inverse_predicted_fp")

    # float RAHT lane: orthonormal (Parseval) and invertible
    rel = rt.parseval_rel_err(colors, r.raht_acs, r.raht_root)
    _check(rel < PARSEVAL_MAX, f"Parseval relative error {rel}")
    recon_err = float(np.abs(r.raht_recon - colors).max())
    _check(recon_err < 0.5, f"float RAHT inverse off by {recon_err}")
    _check(all(v > 0 for v in launches.values()),
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

    from mpeg_pcc_tmc13_tpu_torch import host
    from mpeg_pcc_tmc13_tpu_torch.models.geometry_octree import \
        OctreeContexts
    from mpeg_pcc_tmc13_tpu_torch.ops import octree
    from mpeg_pcc_tmc13_tpu_torch.runtime import device_pipeline as dp
    from mpeg_pcc_tmc13_tpu_torch.utils import morton

    rng = np.random.default_rng(21)
    uniq = np.unique(morton.encode(
        rng.integers(0, 1 << depth, (n, 3), dtype=np.int64)))
    ref = np.concatenate([lv["occ"] for lv in
                          octree.build_levels_np(
                              uniq, depth, octree.CTX_MODE_PARENT)])
    occ, counts = octree.encode_occ_u8(torch.as_tensor(uniq, device=device),
                                       depth, ref.size + 64)
    total = int(counts.sum())
    _check(total == ref.size, "depth-21 node count differs")
    _check(np.array_equal(occ[:total].cpu().numpy(), ref),
           "depth-21 occupancy bytes differ from build_levels_np")

    enc = host.RangeEncoder()
    dp.encode_pipelined(uniq, depth, enc, OctreeContexts(), num_slices=1,
                        device=device)
    dec = host.RangeDecoder(enc.get_bytes())
    (nodes, cnt), = dp.decode_pipelined(dec, OctreeContexts(), depth, 1,
                                        uniq.size, device=device)
    _check(np.array_equal(nodes[:int(cnt)].cpu().numpy(), uniq),
           "depth-21 round trip is not exact")
    _line("e", points=uniq.size, depth=depth, nodes=total,
          bytes_vs_build_levels_np="identical", roundtrip="exact")


def _tile_windows(occ2, ctx2, counts, K):
    """The inputs of every ``decode_tiles`` call of a decode, rebuilt
    from the encoder's analysis rows: per refresh window (level, table,
    context row, count, first tile, tiles).  The table quantises the
    histogram of every symbol coded before the window, as both sides
    build it.  Holds one 2 MB table per window on the card (~0.9 GB at
    the bench size)."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import octree_rans as R
    from mpeg_pcc_tmc13_tpu_torch.ops import rans_lanes as L
    nmax = occ2.shape[1]
    nmax_p = (-(-nmax // K) + 1) * K
    ctx_rows = torch.nn.functional.pad(ctx2, (0, nmax_p - nmax))
    hist = torch.zeros(R.N_CTX * 256, dtype=torch.int32, device=occ2.device)
    out = []
    for l, t0, nt, _ in R._windows(counts, K):
        table = L.quantize_tables_ref(hist.view(R.N_CTX, 256)).reshape(-1)
        out.append((l, table, ctx_rows[l], counts[l], t0, nt))
        lo, hi = t0 * K, min(counts[l], (t0 + nt) * K)
        ix = ctx2[l, lo:hi].to(torch.int64) * 256 + occ2[l, lo:hi]
        hist.index_add_(0, ix, torch.ones_like(ix, dtype=torch.int32))
    return out


def _replay_tiles(fn, run, state):
    """Run ``fn`` (decode_tiles or its plain version) over every window
    of (g)'s decode, from the decode's initial state, which is reset in
    ``state`` (states, cursor, hist, per-level syms) first."""
    states, cursor, hist, syms = state
    states.copy_(run.states0)
    cursor.zero_()
    hist.zero_()
    for buf in syms.values():
        buf.zero_()
    for l, c_flat, ctx_row, count, t0, nt in run.windows:
        fn(c_flat, ctx_row, run.words, states, cursor, syms[l], hist,
           count, t0, nt)
    return state


def _new_tile_state(run):
    import torch
    dev = run.words.device
    syms = {l: torch.zeros(run.nmax_p, dtype=torch.int32, device=dev)
            for l in sorted({w[0] for w in run.windows})}
    return (torch.empty_like(run.states0),
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.zeros(run.n_ctx * 256, dtype=torch.int32, device=dev),
            syms)


def _max_abs_diff(pairs):
    return max(float((a.to(float) - b.to(float)).abs().max())
               if a.numel() else 0.0 for a, b in pairs)


def phase_g(device, uniq, depth, range_coded_bytes):
    """The rANS brick at the bench size through geometry_rans on the
    card: the payload equals the plain versions', the decoded codes equal
    the input, every rANS kernel ran, and each kernel equals its plain
    version at this run's shapes."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.models import geometry_rans as gr
    from mpeg_pcc_tmc13_tpu_torch.ops import octree_rans as R
    from mpeg_pcc_tmc13_tpu_torch.ops import rans_lanes as L
    from mpeg_pcc_tmc13_tpu_torch.utils import morton

    pos = morton.decode(uniq)
    _sync(device)
    L.reset_launch_counts()
    t0 = time.perf_counter()
    payload = gr.encode(pos, depth, device=device)
    t1 = time.perf_counter()
    out = gr.decode(payload, uniq.size, depth, device=device)
    t2 = time.perf_counter()
    launches = dict(L.LAUNCHES)
    _check(all(v > 0 for v in launches.values()),
           f"a rANS kernel was not launched on the main path: {launches}")
    _check(np.array_equal(morton.encode(out), uniq),
           "rANS decoded codes differ from the input")

    # the plain versions of every lane kernel, on the same card
    n = uniq.size
    nmax = gr._bucket(n)
    K = min(gr._lanes_for(n), nmax)
    leaf = np.empty(nmax, dtype=np.int64)
    leaf[:n] = uniq
    leaf[n:] = uniq[-1]
    leaf_d = torch.as_tensor(leaf, device=device)
    buf, _ = R.encode_device(leaf_d, depth, nmax, K, plain=True)
    _check(buf.cpu().numpy().tobytes() == payload[1:],
           "rANS payload differs from the plain versions' on the card")
    counts, states, words = R.parse_payload(
        np.frombuffer(payload, np.uint8)[1:], depth, K)
    wp = np.zeros(gr._bucket(max(64, words.shape[0])), np.int32)
    wp[:words.shape[0]] = words
    states0 = torch.as_tensor(states.astype(np.int64), device=device)
    words_d = torch.as_tensor(wp, device=device)
    nodes, cnt = R.decode_device(counts, states0, words_d, depth, nmax, K,
                                 plain=True)
    _check(np.array_equal(nodes[:int(cnt)].cpu().numpy(), uniq),
           "the plain rANS decode differs from the input")

    # each kernel against its plain version at this run's shapes
    occ2, ctx2, cnt_d = R._analysis(leaf_d, depth, nmax)
    f_steps, c_steps, nvalid, hist = R._table_pass(
        occ2, ctx2, cnt_d.tolist(), K, L.quantize_tables_ref)
    errs = {"quantize_tables": _max_abs_diff(
        [(L.quantize_tables(hist), L.quantize_tables_ref(hist))])}
    errs["encode_emit"] = _max_abs_diff(zip(
        L.encode_emit(f_steps, c_steps, nvalid),
        L.encode_emit_ref(f_steps, c_steps, nvalid)))
    windows = _tile_windows(occ2, ctx2, cnt_d.tolist(), K)
    # what (f) times: the main path's payload and wall times, and the
    # kernels' inputs at (g)'s shapes
    run = SimpleNamespace(
        payload=payload, encode_s=t1 - t0, decode_s=t2 - t1, hist=hist,
        f_steps=f_steps, c_steps=c_steps, nvalid=nvalid, windows=windows,
        states0=states0, words=words_d, nmax_p=(-(-nmax // K) + 1) * K,
        n_ctx=R.N_CTX)
    got = _replay_tiles(L.decode_tiles, run, _new_tile_state(run))
    ref = _replay_tiles(L.decode_tiles_ref, run, _new_tile_state(run))
    last = int(counts[-1])
    _check(int(ref[1]) == words.shape[0]
           and torch.equal(ref[3][depth - 1][:last], occ2[depth - 1, :last]),
           "the rebuilt decode windows do not replay the decode")
    pairs = list(zip(got[:3], ref[:3]))
    pairs += [(got[3][l], ref[3][l]) for l in got[3]]
    errs["decode_tiles"] = _max_abs_diff(pairs)
    _sync(device)
    _check(all(e == 0.0 for e in errs.values()),
           f"a rANS kernel differs from its plain version: {errs}")
    _line("g", points=n, depth=depth, lanes=K, steps=f_steps.shape[0],
          windows=len(windows), rans_bytes=len(payload),
          range_coded_bytes=range_coded_bytes,
          rans_over_range_coded=f"{len(payload) / range_coded_bytes:.4f}",
          payload_vs_plain="identical", decoded_codes="identical",
          kernels_vs_plain=json.dumps(errs, separators=(",", ":")),
          encode_s=f"{run.encode_s:.4f}", decode_s=f"{run.decode_s:.4f}",
          launches=json.dumps(launches, separators=(",", ":")))
    return run, launches, errs


def phase_h(device, n=DEEP_POINTS, depth=DEEP_DEPTH):
    """Depth 21 through the rANS engine: exact round trip, and the
    analysis rows equal the numpy level builder (PARENT contexts)."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.models import geometry_rans as gr
    from mpeg_pcc_tmc13_tpu_torch.ops import octree
    from mpeg_pcc_tmc13_tpu_torch.ops import octree_rans as R
    from mpeg_pcc_tmc13_tpu_torch.utils import morton

    rng = np.random.default_rng(21)
    uniq = np.unique(morton.encode(
        rng.integers(0, 1 << depth, (n, 3), dtype=np.int64)))
    payload = gr.encode(morton.decode(uniq), depth, device=device)
    out = gr.decode(payload, uniq.size, depth, device=device)
    _check(np.array_equal(morton.encode(out), uniq),
           "depth-21 rANS round trip is not exact")
    nmax = gr._bucket(uniq.size)
    leaf = np.full(nmax, uniq[-1], dtype=np.int64)
    leaf[:uniq.size] = uniq
    occ, ctx, counts = R._analysis(torch.as_tensor(leaf, device=device),
                                   depth, nmax)
    occ, ctx = occ.cpu().numpy(), ctx.cpu().numpy()
    levels = octree.build_levels_np(uniq, depth, octree.CTX_MODE_PARENT)
    for l, lv in enumerate(levels):
        k = lv["occ"].size
        _check(int(counts[l]) == k
               and np.array_equal(occ[l, :k], lv["occ"])
               and np.array_equal(ctx[l, :k], lv["ctx_base"]),
               f"depth-21 rANS analysis differs from build_levels_np at "
               f"level {l}")
    _line("h", points=uniq.size, depth=depth, rans_bytes=len(payload),
          roundtrip="exact", analysis_vs_build_levels_np="identical")


def phase_i(device, uniq, depth):
    """geometry_octree engine="device" at the bench size, both context
    modes: the stream equals the shared C++ engine's and decodes back."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch import host
    from mpeg_pcc_tmc13_tpu_torch.models import geometry_octree as go
    from mpeg_pcc_tmc13_tpu_torch.ops import octree
    from mpeg_pcc_tmc13_tpu_torch.utils import morton

    pos = morton.decode(uniq)
    for name, mode in (("NEIGH", octree.CTX_MODE_NEIGH),
                       ("PARENT", octree.CTX_MODE_PARENT)):
        streams, secs = {}, {}
        for engine in ("device", "native"):
            _sync(device)
            enc = host.RangeEncoder()
            t0 = time.perf_counter()
            go.encode(pos, depth, enc, go.OctreeContexts(), engine=engine,
                      ctx_mode=mode, need_order=False, device=device)
            streams[engine] = enc.get_bytes()
            secs[engine] = time.perf_counter() - t0
        _check(streams["device"] == streams["native"],
               f"engine=device stream differs from native ({name})")
        _sync(device)
        t0 = time.perf_counter()
        compact, counts = octree.encode_analysis_packed(
            torch.as_tensor(uniq, device=device), depth, mode)
        counts = counts.cpu().numpy()
        compact[:int(counts.sum())].cpu().numpy()   # the engine's fetch
        analysis_s = time.perf_counter() - t0
        out = go.decode(uniq.size, depth,
                        host.RangeDecoder(streams["device"]),
                        go.OctreeContexts(), engine="native",
                        ctx_mode=mode)
        _check(np.array_equal(morton.encode(out), uniq),
               f"engine=device stream does not decode back ({name})")
        _line("i", mode=name, points=uniq.size, nodes=int(counts.sum()),
              bytes=len(streams["device"]), vs_native="identical",
              decoded="identical", device_encode_s=f"{secs['device']:.4f}",
              native_encode_s=f"{secs['native']:.4f}",
              device_analysis_and_fetch_s=f"{analysis_s:.4f}")


def phase_j(device, uniq, depth, raw_stream):
    """The packed device->host link gives the raw link's stream."""
    from mpeg_pcc_tmc13_tpu_torch import host
    from mpeg_pcc_tmc13_tpu_torch.models.geometry_octree import \
        OctreeContexts
    from mpeg_pcc_tmc13_tpu_torch.runtime import device_pipeline as dp

    link = {}
    for packed in (True, False):
        enc = host.RangeEncoder()
        st = dp.PipelineStats()
        dp.encode_pipelined(uniq, depth, enc, OctreeContexts(),
                            num_slices=1, packed_link=packed, stats=st,
                            device=device)
        _check(enc.get_bytes() == raw_stream,
               f"packed_link={packed} stream differs from (d)'s")
        link[packed] = st
    _line("j", stream_bytes=len(raw_stream), packed_vs_raw="identical",
          packed_link_bytes=link[True].link_bytes,
          raw_link_bytes=link[False].link_bytes,
          packed_wall_s=f"{link[True].wall_s:.4f}",
          raw_wall_s=f"{link[False].wall_s:.4f}")


def _cli(args):
    """Run the port's CLI in this process: (wall s, its stdout)."""
    from mpeg_pcc_tmc13_tpu_torch.runtime import cli
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(args))
    secs = time.perf_counter() - t0
    _check(rc == 0, f"cli {' '.join(args)} exited {rc}:\n{out.getvalue()}")
    return secs, out.getvalue()


def _cli_number(out, pattern):
    m = re.search(pattern, out)
    _check(m is not None, f"no {pattern!r} in the CLI's output")
    return m.group(1)


def _attribute_bricks(path):
    from mpeg_pcc_tmc13_tpu_torch import host
    with open(path, "rb") as f:
        return [b.data for b in host.tlv.iter_tlv(f)
                if b.type == host.tlv.PayloadType.ATTRIBUTE_BRICK]


def _decoded(path, uniq):
    """(positions, colours) of a decoded PLY, Morton-sorted; checks the
    positions are exactly the unique input positions."""
    from mpeg_pcc_tmc13_tpu_torch import host
    from mpeg_pcc_tmc13_tpu_torch.utils import morton
    cloud = host.ply.read(str(path))
    codes = morton.encode(np.round(cloud.positions).astype(np.int64))
    order = np.argsort(codes, kind="stable")
    _check(np.array_equal(codes[order], uniq),
           f"{path.name}: decoded positions are not the unique input")
    return cloud.colors[order]


@contextlib.contextmanager
def _timed(module, name, secs):
    """Add the wall time of every call of ``module.name`` to
    ``secs[name]`` while the block runs."""
    fn = getattr(module, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


def phase_k(device, uniq, depth, colors, smi):
    """The port's CLI at the bench size, each geometry engine on the
    default device of the run (on the card no --device is given)."""
    from mpeg_pcc_tmc13_tpu_torch import host
    from mpeg_pcc_tmc13_tpu_torch.models import attributes
    from mpeg_pcc_tmc13_tpu_torch.ops import octree
    from mpeg_pcc_tmc13_tpu_torch.ops import rans_lanes as L
    from mpeg_pcc_tmc13_tpu_torch.utils import morton

    extra = [] if device.type == "cuda" else [f"--device={device}"]
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    src = CLI_DIR / "bench.ply"
    host.ply.write(host.ply.PlyCloud(
        positions=morton.decode(uniq).astype(np.float64), colors=colors),
        str(src))
    # spy: the torch device of every engine="device" analysis
    analysed = []
    packed = octree.encode_analysis_packed

    def spy(codes, *a, **k):
        analysed.append(codes.device.type)
        return packed(codes, *a, **k)

    octree.encode_analysis_packed = spy
    runs = {}
    try:
        for engine in ("native", "device", "rans"):
            bin_path = CLI_DIR / f"{engine}.bin"
            rec = CLI_DIR / f"{engine}.ply"
            analysed.clear()
            attr_s = {}
            _sync(device)
            L.reset_launch_counts()
            with _timed(attributes, "encode", attr_s):
                enc_s, enc_out = _cli(
                    ["--mode=0", f"--uncompressedDataPath={src}",
                     f"--compressedStreamPath={bin_path}",
                     f"--geomEngine={engine}", *CLI_FLAGS, *extra])
            enc_launches = dict(L.LAUNCHES)
            L.reset_launch_counts()
            with _timed(attributes, "decode", attr_s):
                dec_s, dec_out = _cli(
                    ["--mode=1", f"--compressedStreamPath={bin_path}",
                     f"--reconstructedDataPath={rec}", *extra])
            dec_launches = dict(L.LAUNCHES)
            runs[engine] = SimpleNamespace(
                stream=bin_path.read_bytes(), colors=_decoded(rec, uniq),
                bricks=_attribute_bricks(bin_path), analysed=list(analysed),
                enc_launches=enc_launches, dec_launches=dec_launches)
            _line("k", engine=engine, points=uniq.size,
                  encode_s=f"{enc_s:.3f}",
                  encode_cli_wall_s=_cli_number(
                      enc_out, r"Processing time \(wall\): ([\d.]+)"),
                  attr_encode_s=f"{attr_s['encode']:.3f}",
                  decode_s=f"{dec_s:.3f}",
                  decode_cli_wall_s=_cli_number(
                      dec_out, r"Processing time \(wall\): ([\d.]+)"),
                  attr_decode_s=f"{attr_s['decode']:.3f}",
                  geom_bytes=_cli_number(
                      enc_out, r"positions bitstream size (\d+) B"),
                  color_bytes=_cli_number(
                      enc_out, r"colors bitstream size (\d+) B"),
                  stream_bytes=len(runs[engine].stream),
                  analysis_devices=",".join(analysed) or "none",
                  rans_launches_encode=json.dumps(enc_launches,
                                                  separators=(",", ":")),
                  rans_launches_decode=json.dumps(dec_launches,
                                                  separators=(",", ":")))
    finally:
        octree.encode_analysis_packed = packed

    nat, dev, rans = runs["native"], runs["device"], runs["rans"]
    _check(dev.stream == nat.stream,
           "the --geomEngine=device stream differs from the native one")
    _check(dev.analysed == [device.type] and not nat.analysed,
           f"the device engine analysed on {dev.analysed}, not "
           f"{device.type}")
    for other in (dev, rans):
        _check(np.array_equal(other.colors, nat.colors),
               "decoded colours differ between the geometry engines")
    total = {k: rans.enc_launches[k] + rans.dec_launches[k]
             for k in rans.enc_launches}
    _check(all(v > 0 for v in total.values())
           and rans.dec_launches["decode_tiles"] > 0,
           f"a rANS kernel was not launched under the CLI: {total}")

    # the rANS stream decoded by the command a user runs
    sub = CLI_DIR / "rans_subprocess.ply"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mpeg_pcc_tmc13_tpu_torch.runtime.cli",
         "--mode=1", f"--compressedStreamPath={CLI_DIR / 'rans.bin'}",
         f"--reconstructedDataPath={sub}", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    _check(res.returncode == 0,
           f"the CLI process failed ({res.returncode}):\n{res.stderr}")
    _check(sub.read_bytes() == (CLI_DIR / "rans.ply").read_bytes(),
           "the CLI process decoded another PLY than the in-process one")
    _line("k", device_vs_native_stream="identical",
          positions="unique_input_x3", colors="equal_x3",
          attribute_bricks=("identical_x3" if nat.bricks == dev.bricks
                            == rans.bricks else "differ"),
          rans_launches=json.dumps(total, separators=(",", ":")),
          subprocess_decode_s=f"{sub_s:.3f}",
          subprocess_cli_wall_s=_cli_number(
              res.stdout, r"Processing time \(wall\): ([\d.]+)"),
          subprocess_ply="identical", card=repr(smi))
    return total


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


def _time_pass_ms(run_pass, reps=TIMING_REPS):
    """ms of one ``run_pass()``, CUDA events over ``reps`` passes after a
    warm-up pass."""
    import torch
    run_pass()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run_pass()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _graph_ms(run_pass, reps=TIMING_REPS):
    """Device ms of one ``run_pass()``: the pass captured once in a CUDA
    graph (the wrappers enqueue on the current stream, which is the
    capture stream), its replays timed with CUDA events, so host issue
    time drops out."""
    import torch
    run_pass()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run_pass()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / reps
    del graph
    return ms


def _io_bytes(*tensors):
    """Bytes of the given tensors, each counted once."""
    import torch
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _bound_ms(nbytes, flops=0.0):
    """(least ms, what bounds it): the bytes over the H100's memory rate
    against the fp32 operations over its fp32 rate outside the tensor
    cores."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / FP32_FLOPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def _turns(name, kern, ref, reps_plain=TIMING_REPS, **shape):
    """Plain, kernel, kernel, plain, then the kernel's pass as a replayed
    CUDA graph twice; returns (kernel ms, plain ms, device ms)."""
    p1 = _time_pass_ms(ref, reps_plain)
    k1 = _time_pass_ms(kern)
    k2 = _time_pass_ms(kern)
    p2 = _time_pass_ms(ref, reps_plain)
    d1 = _graph_ms(kern)
    d2 = _graph_ms(kern)
    _line("f", kernel=name, **shape, kernel_ms=f"{k1:.4f},{k2:.4f}",
          plain_ms=f"{p1:.4f},{p2:.4f}", device_ms=f"{d1:.4f},{d2:.4f}")
    return min(k1, k2), min(p1, p2), min(d1, d2)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _level_check(name, kern, ref, inputs, device):
    """``kern`` against ``ref`` on each level's inputs: the max abs
    difference over all outputs; fails unless every output is
    identical."""
    import torch
    err = 0.0
    for a in inputs:
        got, want = _as_tuple(kern(*a)), _as_tuple(ref(*a))
        _sync(device)
        err = max(err, _max_abs_diff(zip(got, want)))
        _check(all(torch.equal(g, w) for g, w in zip(got, want)),
               f"{name} differs from its plain version at a level of (d) "
               f"(B={a[0].shape[0]}): max abs {err}")
    return err


def _block_times(device, uniq, depth, colors, errs):
    """B1/B2 over the float lane's levels of (d): each level's outputs
    against the plain version's, bit for bit (into ``errs``), then the
    pass through the wrappers (CUDA events), its device time (graph
    replay), the largest level alone, and the bound of each."""
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_blocks as rb
    fwd, inv = _level_inputs(uniq, colors, depth, device)
    times = {}
    for name, kern, ref, inputs in (
            ("fwd_blocks", rb.fwd_blocks, rb.fwd_blocks_ref, fwd),
            ("inv_blocks", rb.inv_blocks, rb.inv_blocks_ref, inv)):
        err = _level_check(name, kern, ref, inputs, device)
        errs[name] = max(errs[name], err)
        _line("f", kernel=name, levels_checked=len(inputs),
              outputs="identical", level_max_abs_err=err, tol=0)
        nblocks = sum(a[0].shape[0] for a in inputs)
        k, p, d = _turns(
            name, lambda: [kern(*a) for a in inputs],
            lambda: [ref(*a) for a in inputs], levels=len(inputs),
            blocks=nblocks)
        nbytes = sum(_io_bytes(*a, *ref(*a)) for a in inputs)
        nchan = inputs[0][0].shape[2]
        # per pair: 3 sqrt, 2 divisions, an add, compares and selects;
        # per pair and channel: 4 products and 2 sums
        bound, by = _bound_ms(nbytes, nblocks * 7 * (6 + 6 * nchan))
        big = max(inputs, key=lambda a: a[0].shape[0])
        big_ms = _graph_ms(lambda: kern(*big))
        big_bound, _ = _bound_ms(_io_bytes(*big, *ref(*big)))
        _line("f", kernel=name, pass_ms=f"{k:.4f}", device_ms=f"{d:.4f}",
              bound_ms=f"{bound:.4f}", bound_by=by,
              share=f"{bound / d:.3f}", bytes=nbytes,
              largest_level_blocks=big[0].shape[0],
              largest_level_ms=f"{big_ms:.4f}",
              largest_level_bound_ms=f"{big_bound:.4f}",
              largest_level_share=f"{big_bound / big_ms:.3f}")
        times[name] = (k, p, d, bound, by)
    return times


def phase_f(device, uniq, depth, colors, rans, errs):
    """Stage times of a warm round trip and of a warm rANS round trip,
    B1/B2 checked at every level of (d), and each kernel timed against
    its plain version at the shapes of (d) and (g), in turns plain,
    kernel, kernel, plain."""
    from mpeg_pcc_tmc13_tpu_torch.models import geometry_rans as gr
    from mpeg_pcc_tmc13_tpu_torch.ops import rans_lanes as L
    from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt
    from mpeg_pcc_tmc13_tpu_torch.utils import morton

    r = rt.device_roundtrip(uniq, depth, colors, qp=BENCH_QP, device=device)
    _line("f", warm_stage_s=json.dumps(
        {k: round(v, 6) for k, v in r.stage_s.items()},
        separators=(",", ":")),
        host_entropy_s=r.geom_stats.host_entropy_s,
        link_bytes=r.geom_stats.link_bytes)
    pos = morton.decode(uniq)
    _sync(device)
    t0 = time.perf_counter()
    payload = gr.encode(pos, depth, device=device)
    t1 = time.perf_counter()
    gr.decode(payload, uniq.size, depth, device=device)
    t2 = time.perf_counter()
    _check(payload == rans.payload, "warm rANS payload differs from (g)'s")
    _line("f", rans_encode_s=f"{rans.encode_s:.4f},{t1 - t0:.4f}",
          rans_decode_s=f"{rans.decode_s:.4f},{t2 - t1:.4f}",
          note="first,warm")

    times = _block_times(device, uniq, depth, colors, errs)
    nwin = len(rans.windows)
    k, p, d = _turns(
        "quantize_tables",
        lambda: [L.quantize_tables(rans.hist) for _ in range(nwin)],
        lambda: [L.quantize_tables_ref(rans.hist) for _ in range(nwin)],
        calls=nwin, shape="2048x256")
    times["quantize_tables"] = (k, p, d, *_bound_ms(
        nwin * 2 * _io_bytes(rans.hist)))
    args = (rans.f_steps, rans.c_steps, rans.nvalid)
    k, p, d = _turns(
        "encode_emit", lambda: L.encode_emit(*args),
        lambda: L.encode_emit_ref(*args), reps_plain=SLOW_REPS,
        steps=rans.f_steps.shape[0], lanes=rans.f_steps.shape[1])
    times["encode_emit"] = (k, p, d, *_bound_ms(
        _io_bytes(*args, *L.encode_emit(*args))))
    st_k, st_p = _new_tile_state(rans), _new_tile_state(rans)
    k, p, d = _turns(
        "decode_tiles", lambda: _replay_tiles(L.decode_tiles, rans, st_k),
        lambda: _replay_tiles(L.decode_tiles_ref, rans, st_p),
        reps_plain=SLOW_REPS, calls=nwin, lanes=rans.f_steps.shape[1])
    times["decode_tiles"] = (k, p, d, *_bound_ms(_tiles_bytes(rans,
                                                            st_k[3])))
    for name in ("quantize_tables", "encode_emit", "decode_tiles"):
        k, p, d, bound, by = times[name]
        _line("f", kernel=name, pass_ms=f"{k:.4f}", device_ms=f"{d:.4f}",
              bound_ms=f"{bound:.4f}", bound_by=by,
              share=f"{bound / d:.4f}")
    return times


def _tiles_bytes(run, syms):
    """What ``decode_tiles`` must move over (g)'s decode, from this
    run's decoded symbols ``syms`` (per level): per window the context
    id it reads and the symbol it writes for each decoded symbol, the
    table entries c[s-1] and c[s] of each distinct (context, symbol) it
    decodes, and each distinct histogram bin it bumps, read and written
    once; the words once; the lane states in and out."""
    import torch
    K = run.states0.shape[0]
    nbytes = run.words.shape[0] * 4 + 2 * _io_bytes(run.states0)
    for l, _, ctx_row, count, t0, nt in run.windows:
        a, b = t0 * K, min(count, (t0 + nt) * K)
        if b <= a:
            continue
        bins = ctx_row[a:b].long() * 256 + syms[l][a:b].long()
        entries = torch.unique(torch.cat([bins - 1, bins])).numel()
        nbytes += (b - a) * 8 + entries * 4 + torch.unique(bins).numel() * 8
    return nbytes


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs only on a CUDA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)

    # (a) device identity
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _line("a", torch_device=repr(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    # (b) builds from the sources in this checkout: the port's native
    # host library (g++, on the package's first import) and the CUDA
    # kernels (nvcc)
    from mpeg_pcc_tmc13_tpu_torch.bitstream import entropy
    from mpeg_pcc_tmc13_tpu_torch.ops import _kernels
    if not entropy.native_available():
        raise RuntimeError("the port's native library did not build")
    _line("b", native_library=os.path.relpath(entropy.LIB_PATH, REPO),
          gxx_s=f"{entropy.BUILD_SECONDS:.1f}",
          gxx_flags="_".join(entropy.CXXFLAGS))
    so, secs = _kernels.build()
    _kernels.load()
    _line("b", library=so.name, nvcc_s=f"{secs:.1f}",
          flags=" ".join(_kernels.NVCC_FLAGS).replace(" ", "_"))

    errs = phase_c(device)                                     # (c)
    uniq, colors = bench_cloud()
    r, launches = phase_d(device, uniq, BENCH_DEPTH, colors)   # (d)
    phase_e(device)                                            # (e)
    rans, rans_launches, rans_errs = phase_g(                  # (g)
        device, uniq, BENCH_DEPTH, len(r.geom_payload))
    launches.update(rans_launches)
    errs.update(rans_errs)
    phase_h(device)                                            # (h)
    phase_i(device, uniq, BENCH_DEPTH)                         # (i)
    phase_j(device, uniq, BENCH_DEPTH, r.geom_payload)         # (j)
    phase_k(device, uniq, BENCH_DEPTH, colors, smi)            # (k)
    times = phase_f(device, uniq, BENCH_DEPTH, colors, rans,   # (f)
                    errs)

    kernels = []
    for key, (name, src, replaces) in KERNELS.items():
        ms, plain_ms, device_ms, bound_ms, bound_by = times[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpeg_pcc_tmc13_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
            "device_ms": device_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
