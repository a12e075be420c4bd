#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (``mpeg_pcc_tmc13_tpu_torch``) once on
``cuda:0`` ((m): on every visible card) at the bench size, one phase per
printed line:

  (a) device identity: torch's device name and nvidia-smi's name and
      power limit (the nvidia-smi line is printed on its own),
  (b) build of the port's native host library from ``native/`` with g++
      (its path and build seconds) and of the hand-written CUDA kernels
      from ``csrc/`` with nvcc, with ptxas's registers, shared memory and
      spills of ``raht_fp_group``, ``octree_expand`` and the planner's
      ``plan_blocks``,
  (c) each block kernel against its plain PyTorch version on the card,
      bit for bit, at ragged batch sizes and all 256 occupancy patterns,
      for 1 and 3 channels and, through the wrappers' split into runs of
      3 and 1, for 2 and 5; the float RAHT lane at 2 channels on the card,
  (d) the device round trip at the bench size (1M-point surface cloud,
      depth 11, qp 22): geometry encode/decode, fixed-point RAHT colour
      encode/decode, the float RAHT lane, each checked against its
      reference, with the kernels' launch counts from this run (the
      block kernels and the headline path's five: the occupancy pass,
      the expansion, the RAHT planner, the truth levels and the coded
      groups); first, the entry points called without a device run on
      ``cuda:0``,
  (p) the headline path's four kernels against their plain versions at
      the bench cloud's shapes, every level and group, max abs
      difference 0: ``octree_occ_u8`` at the pipeline's cap and at an
      undersized one, the expansion level by level and as
      ``decode_expand_stream``, ``raht_fp_truth_level`` at each truth
      level and ``raht_fp_group`` at each encode and decode group called
      alone, then both as ``DeviceFpRaht`` runs them against the plain
      loop on one plan; the expansion also on a stream whose first
      levels hold one node (nmax filled exactly and not), the group also
      on parents of +-2^62 (its division's general path), with the
      kernel's count of fast and general divisions there and over the
      main path's 22 groups, and ``DeviceFpRaht``'s loop at 5 channels
      (two channel windows) against the plain loop; and the RAHT
      planner ``build_plan`` on the bench cloud's codes against its
      plain version on the card and against the host spec
      (``build_fp_plan``, ``plans_to_torch``, ``row_offsets``), every
      level's tensors and the counts, each tensor 16-byte aligned,
  (q) the colour brick's float predicted RAHT on the card
      (``ops/raht_float_device.py``) at one body frame of the
      benchmark's ``vox10_body_cli`` configuration (~856,500 points,
      depth 10): (q1) each of its three kernels against its plain
      version on the card at every launch of an encode and a decode of
      the frame's RGB (max abs difference 0, launch counts), the
      residual rows and the reconstruction equal to numpy's loop bit for
      bit, then each
      kernel's device time over a warm encode (CUDA events around each
      launch, recorded behind a spin kernel that covers the launch's
      host work) beside its byte bound, its launch wall and its plain
      version's wall; (q2) the frame through
      ``tmc3-cuda``'s path in process (the benchmark's codec), the card
      loop against the numpy path: the same attribute brick bytes and
      decoded RGB, with each path's traced brick times and the card
      path's launches in its own encode and decode (depth truth and
      prediction launches a side, depth - 1 inverse launches an encode,
      depth a decode); (q3)
      ``tmc3-cuda --mode=1`` in a process of its own decodes the card
      loop's stream to the same cloud,
  (e) a depth-21 geometry round trip (the 63-bit Morton domain),
  (g) the rANS brick at the bench size through ``models.geometry_rans``
      (one table-pass launch and one emission per encode, one decode
      launch per level), its payload held to the plain versions on the
      card, each kernel held to its plain version at the shapes of this
      run (the decoder at every level, from the plain decode's state)
      and on context rows of more than 2^23 counts, the emission also at
      a lane count that is no multiple of its block's lanes and at fewer
      steps than one of its slabs, its size beside (d)'s range-coded
      stream, and the same checks on two small slices (K = 64 and 256),
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
  (l) the rest of the CLI, every failure fatal: the tmc3 syntax family
      (``--refSyntax=1``) on the bench cloud with RAHT colour and with no
      other flag (tmc3's predicting transform), each stream decoded in
      this process and in a separate one with no ``--refSyntax``
      (geometry exact, the same PLY bytes, the stream's size and SHA-256
      equal to the JAX CLI's on the same cloud); trisoup geometry on the
      bench cloud through the reference-exact brick
      (``--geomEngine=obuf``, and under ``--refSyntax=1``), sizes and
      SHA-256 pinned the same way, the decoded count equal to the
      encoder's reconstruction and every decoded point within
      ``TRISOUP_MAX_DISTANCE`` voxels of a source point; and trisoup's
      numpy surface model on a smaller cloud (``TRISOUP_V2_POINTS``,
      depth 10: it costs tens of seconds a side) with
      ``--geomEngine=device`` (the octree front-end analysed on the
      card) and ``native``: identical streams, and the decode equal to
      the encoder's reconstruction,
  (m) the multi-device layer (``parallel/``) on a mesh of every visible
      card, the bench cloud cut into 8 slices, the launch counts taken
      over (m1)-(m7): (m1) the sharded analysis, each slice equal to
      ``encode_analysis`` and the histogram to the host sum; (m2) the
      sharded codec round trip (bytes equal to the host engine's, the
      cloud back); (m3) the inter analysis against the cloud moved one
      voxel, every level equal to ``pred_occupancy_np``; (m4) the
      fixed-point block stage on the float lane's 1,825,667 blocks with
      Q13 values from a seed, ``raht_fwd_blocks_int`` equal to its plain
      version and a sample to ``raht_fp``'s pair law; (m5) B1 on every
      device equal to its plain version; (m6) the frame codec placed
      slice by slice with (d)'s colours, geometry equal to the host
      engine's, colour to ``forward_predicted_fp``'s, decoded codes to the
      input; (m7) ``dryrun_multichip``; then ``raht_fwd_blocks_int``
      held to its plain version at B in {1, 127, 128, 129, 300,001} x C
      in {1, 2, 3, 5, 28, 32} (ragged tiles, the persistent grid's tail,
      runs of 4 channels, general-path blocks among fast ones, values
      that wrap), one launch a run, and timed at (m4)'s shapes at C = 3
      and 1 beside its byte bound and its issue bound (the fast path's
      SASS instructions a block from ``cuobjdump``, at the SM clock
      nvidia-smi reads under load),
  (n) the evaluation layer (``scripts/``, ``tools/pc_error``) as a user
      runs it, every failure fatal, each result pinned to what the
      repo's JAX scripts give on a CPU from the same seeds: (n1)
      ``gen_clouds`` writes the 1.22M-point surface and one 468k-point
      LiDAR frame into ``data/`` (SHA-256 pinned); (n2) ``ctc_matrix``
      on its default seeded cloud, the 14 families' CLI runs through
      ``runtime.cli.main`` in this process and one decode in a CLI
      process of its own (stream and decoded md5s pinned); (n3)
      ``parity``, codec ``ours``, each CLI run a process, at r04 on
      (n1)'s inputs for four conditions (stream bytes and bpp exact,
      D1/D2/Y PSNR within ``PSNR_TOL_DB``), each row with its encode and
      decode rates; (n4) ``mesh_scaling`` on every visible card, each
      mesh size's payload bytes equal to the host engine's and pinned,
      ``raht_fwd_blocks_int`` launched on the card,
  (o) the port's benchmark as a user runs it (``python -m
      mpeg_pcc_tmc13_tpu_torch.bench``, a process of its own, its last
      line parsed): every key of ``BENCH_r05.json``'s line but
      ``device_attr_error``, the ``device_attr_*`` lanes and
      ``device_geom_rt_mpts``, no ``*_error`` key, its sizes equal to
      the TPU run's (``BENCH_SIZES``, which the JAX package gives on a
      CPU too) and ``device_attr_bpp`` to the JAX package's on a CPU,
      ``device_numerics_ok`` and ``device_attr_ok`` true; then
      ``entry.entry()`` on the default CUDA device, its outputs' SHA-256
      equal to the JAX ``__graft_entry__.entry()``'s on a CPU,
  (f) timing: the stage times of a second (warm) round trip, and each
      kernel against its plain version at the shapes of (d), (g) and (p):
      the pass through the wrappers (CUDA events), its device time (the
      pass replayed as a CUDA graph), the largest level alone for the
      block kernels and the expansion and the largest group alone, each
      kernel's bound (the groups' SASS instructions at the SM clock
      beside it, as a diagnostic of the code, not a bound) and, for the
      rANS kernels and the expansion, the serial chain that
      floors them (as a time: its steps times one step's dependent
      latency, measured by running the chain alone); the RAHT planner
      as ``DeviceFpRaht`` runs it on the bench cloud (not a graph: it
      reads its counts on the host), its three kernels' device time
      from ``torch.profiler``, its byte bound, and the host planner it
      replaced with its upload; plus the rANS
      encode/decode wall times, first and warm, and one warm rANS encode
      and decode under ``torch.profiler``:
      the device operations that took most time, the device-busy share
      of the wall, and the host calls that wait for the device.

Then the script's own wall time (``[z] smoke_s=``), one JSON line with
the kernels and, last, the result line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero; without CUDA it exits non-zero before any phase.
It imports no jax.
"""

from __future__ import annotations

import contextlib
import hashlib
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
SPLIT_CHANNELS = (2, 5)         # channel counts that go in runs of 3 and 1
LANE_INVERSE_MAX = 2e-3         # float32 lane, forward then inverse
EMIT_RAGGED_LANES = 1000        # no multiple of the emission's 32 lanes
PARSEVAL_MAX = 1e-3
TIMING_REPS = 10
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA's data sheet
FP32_FLOPS_PER_S = 67e12        # fp32 outside the tensor cores

SLOW_REPS = 2                   # plain rANS passes take ~1 s each
WIDE_ROW_OCCURRENCES = (1 << 23) + 5 * 4096   # past 2^23 for 5 windows
WARM_RANS_REPS = 3              # warm rANS encode + decode round trips
RANS_KERNELS = ("table_pass", "encode_emit", "decode_level")
REPO = Path(__file__).resolve().parent
CLI_DIR = REPO / "build" / "chip_smoke_cli"      # git-ignored
CLI_FLAGS = ("--attribute=color", "--transformType=0", f"--qp={BENCH_QP}")
# (l): per-attribute options stand before the --attribute= that closes
# them.  Size and SHA-256 of each stream are the JAX CLI's on the same
# cloud (889,682 points), from a run of it on a CPU: the card's run is
# held to the reference's bytes without JAX on its machine.
RAHT_COLOUR = ("--transformType=0", f"--qp={BENCH_QP}", "--attribute=color")
REF_SYNTAX_RUNS = {
    "ref_raht": (("--refSyntax=1", *RAHT_COLOUR), 1_093_554,
                 "c886f569c85bb9bae19a50612c6e307d"
                 "bc364a965618251beda1ffce1cd05008"),
    "ref_zero_flag": (("--refSyntax=1", "--attribute=color"), 2_760_952,
                      "a39fd34a6304d15d186c879fa122e36f"
                      "2566ba7673b8888e46d4b1ae0a90f151"),
}
TRISOUP_LOG2 = 3
TRISOUP_EXACT_RUNS = {
    "trisoup_obuf": ((f"--trisoupNodeSizeLog2={TRISOUP_LOG2}",
                      "--geomEngine=obuf", "--attribute=color"), 928_758,
                     "fbcded45237b6b1af2a78362c2ae2039"
                     "0fdbc081367215d7cf2286bffe0bac59"),
    "trisoup_ref_syntax": (("--refSyntax=1",
                            f"--trisoupNodeSizeLog2={TRISOUP_LOG2}",
                            "--attribute=color"), 1_762_312,
                           "62eb4498d971666880d1e4e28398922c"
                           "0c4ff8089d53af20b54f9e42609519a2"),
}
TRISOUP_EXACT_POINTS = 766_261   # both reconstructions, as the JAX CLI's
TRISOUP_MAX_DISTANCE = 1 << TRISOUP_LOG2     # one node, Chebyshev
# the numpy surface model: a cloud (19,811 unique points) that keeps its
# two encodes and one decode near a minute on the host of an H100
TRISOUP_V2_POINTS = 20_000
TRISOUP_V2_DEPTH = 10
TRISOUP_V2_BYTES = 104_970      # the JAX CLI's stream on that cloud

KERNELS = {
    "fwd_blocks": ("raht_fwd_blocks", "raht_blocks.cu",
                   "mpeg_pcc_tmc13_tpu/ops/pallas_raht.py:48"),
    "inv_blocks": ("raht_inv_blocks", "raht_blocks.cu",
                   "mpeg_pcc_tmc13_tpu/ops/pallas_raht.py:140"),
    "table_pass": ("rans_table_pass", "rans_lanes.cu",
                   "mpeg_pcc_tmc13_tpu/ops/octree_rans.py:234"),
    "encode_emit": ("rans_encode_emit", "rans_lanes.cu",
                    "mpeg_pcc_tmc13_tpu/ops/octree_rans.py:264"),
    "decode_level": ("rans_decode_level", "rans_lanes.cu",
                     "mpeg_pcc_tmc13_tpu/ops/octree_rans.py:353"),
    "fwd_blocks_int": ("raht_fwd_blocks_int", "raht_fp_blocks.cu",
                       "mpeg_pcc_tmc13_tpu/ops/raht_fp_device.py:303"),
    "octree_occ_u8": ("octree_occ_u8", "octree_levels.cu",
                      "mpeg_pcc_tmc13_tpu/ops/octree.py:417"),
    "octree_expand": ("octree_expand_level", "octree_levels.cu",
                      "mpeg_pcc_tmc13_tpu/ops/octree.py:601"),
    "raht_fp_truth_level": ("raht_fp_truth_level", "raht_fp_loop.cu",
                            "mpeg_pcc_tmc13_tpu/ops/raht_fp_device.py:335"),
    "raht_fp_group": ("raht_fp_group", "raht_fp_loop.cu",
                      "mpeg_pcc_tmc13_tpu/ops/raht_fp_device.py:342"),
    # no TPU kernel: the JAX package plans on the host and uploads
    "raht_fp_plan": ("raht_fp_plan", "raht_fp_plan.cu",
                     "mpeg_pcc_tmc13_tpu/ops/raht_fp_device.py:99"),
    # no TPU kernel: the JAX package runs the float predicted RAHT
    # (forward_predicted / inverse_predicted) in host numpy
    "raht_float_truth": ("raht_float_truth", "raht_float_loop.cu",
                         "mpeg_pcc_tmc13_tpu/ops/raht.py:353"),
    "raht_float_predict": ("raht_float_predict", "raht_float_loop.cu",
                           "mpeg_pcc_tmc13_tpu/ops/raht.py:212"),
    "raht_float_inverse": ("raht_float_inverse", "raht_float_loop.cu",
                           "mpeg_pcc_tmc13_tpu/ops/raht.py:375"),
}
# the planner's three kernels, by a part of their entry names
PLAN_KERNELS = ("plan_count_kernel", "plan_scatter_kernel",
                "plan_blocks_kernel")
PLAN_PLAIN_REPS = 2             # the plain planner takes ~0.2 s a pass
MESH_SLICES = 8                 # (m): the bench cloud cut into 8 slices
MESH_VALUE_SEED = 8             # (m4): its Q13 values
PAIR_LAW_SAMPLE = 4096          # (m4): blocks held to raht_fp's pair law
# (n): the evaluation layer.  Every pinned value below is what the repo's
# own scripts (scripts/gen_clouds.py, ctc_matrix.py, parity.py and
# mesh_scaling.py, on the JAX package) give on a CPU from the same seeds,
# so the card's run is held to them without JAX on its machine.
EVAL_DIR = REPO / "build" / "chip_smoke_eval"     # git-ignored
DATA_DIR = REPO / "data"        # git-ignored; where parity reads its inputs
GEN_CLOUDS = {                  # file: (gen_clouds arguments, SHA-256)
    "surface_1m.ply": (("surface",), "3f06f00bd7b3043c40e7601db89e8a95"
                                     "56e390f73716d28ffc976f2640f90407"),
    "lidar_0000.ply": (("lidar",), "7419b88a6d3e4a42d8203f481ec648f2"
                                   "892c24f6d98b2d853cf120d475034bc3"),
}
CTC_MATRIX_MD5 = {              # family: (stream md5, decoded PLY md5)
    "octree-raht-lossless": ("30d335a79f1a81106b53cc73ca7e0097",
                             "ff55831c9af70a9342ee3aa5e6af2cdc"),
    "octree-raht-lossy": ("d13ddd7500bd7ac022d5466da1f08a78",
                          "f8f1e3a2551d095db29943acb5af6dc0"),
    "octree-predlift": ("23da03629c0e839b7c331f774ab3a242",
                        "65ebc40aa0070d50224259cb10ce1c2b"),
    "trisoup-raht": ("6b597a98ad3764b560a943838bf0babf",
                     "b7b4c8a9af677e7a28fc3906f57c3cdc"),
    "predgeom-angular": ("daac3e415307c07eb8f80970cf9eac5d",
                         "97494be9d1d5eb300ad394149f5a7e28"),
    "octree-inter-gm": ("81d44d4aa738190f76e7c825eaec61c3",
                        "8473d5e504c583e4e991332c83113da1"),
    "multistream-parent-ctx": ("62befc69ff1e6169dd6667d5c1c015de",
                               "8473d5e504c583e4e991332c83113da1"),
    "tiles-slices-qp": ("d9d9b320863cd0b7ad02246c0ef3f151",
                        "cb8749141bdb7db9a599b8c3fae881a1"),
    "bipred-attr-inter": ("6a2c5dbedc08e399320d77638ad12949",
                          "ff55831c9af70a9342ee3aa5e6af2cdc"),
    "obuf-planar": ("e13c357b152b7ba14cd60c652e39b17e",
                    "8473d5e504c583e4e991332c83113da1"),
    "planar-sparse-deep": ("ca2e702da88164c844be9d3771bef5a0",
                           "8473d5e504c583e4e991332c83113da1"),
    "idcm-deep": ("9afdfbd452e26ab8b0f48e872621f86a",
                  "8473d5e504c583e4e991332c83113da1"),
    "multislice-trisoup": ("df39725419eaa475554f14f2da3e17a7",
                           "db90fa9e27d789aefcf7b6e7a7f1130f"),
    "pernode-qp": ("e162c2251cff882c48b872e028cca2b8",
                   "8473d5e504c583e4e991332c83113da1"),
}
CTC_SUBPROCESS_FAMILY = "octree-raht-lossy"    # (n2): decoded again by
                                                # a CLI process
PARITY_RATE = "r04"
PARITY_R04 = {                  # codec "ours": the JAX harness's rows
    "octree-lossy-geom": dict(
        points=468416, bytes=115002, geom_bpp=1.9636903948626863,
        attr_bpp=0.0, total_bpp=1.9641002869244433,
        d1_psnr=70.90122625180814, d2_psnr=76.48915882329155, y_psnr=None),
    "octree-angular": dict(
        points=468416, bytes=103771, geom_bpp=1.7648756660746003,
        attr_bpp=0.0, total_bpp=1.7722878808580407,
        d1_psnr=71.6610457744783, d2_psnr=81.03064671016895, y_psnr=None),
    "predgeom-angular": dict(
        points=468416, bytes=452994, geom_bpp=7.729146741358109,
        attr_bpp=0.0, total_bpp=7.736610192649269,
        d1_psnr=73.97347342767388, d2_psnr=98.13607522881604, y_psnr=None),
    "octree-raht-lossy": dict(
        points=1222438, bytes=269400, geom_bpp=1.7529428895371382,
        attr_bpp=0.009790271572055188, total_bpp=1.7630341988714355,
        d1_psnr=67.97215891436048, d2_psnr=72.73135158841193,
        y_psnr=34.956913344288594),
}
PSNR_TOL_DB = 1e-6
MESH_GEOM_BYTES = {1: 295_535, 2: 303_730, 4: 315_408, 8: 330_295}
# (o): the sizes bench.py printed on the TPU (BENCH_r05.json), which the
# JAX package's host lanes give on a CPU as well: 993,881 B of rANS and
# 1,835,052 raw link bytes over 889,682 points among them
BENCH_SIZES = {"geom_bpp": 7.37, "raht_bpp": 2.46, "obuf_bpp": 6.474,
               "rans_bpp": 8.937, "link_bytes_per_point": 2.06}
# 307,541 B over 889,682 points: the JAX DeviceFpRaht on a CPU from the
# same seeds (bench.py's device lane, never run on the TPU)
DEVICE_ATTR_BPP = 2.765
# the lanes BENCH_r05.json's line lacks
BENCH_PORT_KEYS = ("device_attr_plan_s", "device_attr_encode_mpts",
                   "device_attr_bpp", "device_attr_decode_mpts",
                   "device_attr_ok", "device_geom_rt_mpts")
BENCH_TIMEOUT_S = 600
# SHA-256 of __graft_entry__.entry()'s valid outputs (compact[:total],
# then counts, int32) from the JAX package on a CPU
ENTRY_SHA256 = ("cb4e170c7d14cba7ff739354aa07d6ba"
                "9ada8cab06bca4363096f60b0a1d0a4a")


def _line(tag, **kv):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _reset_launches():
    from mpeg_pcc_tmc13_tpu_torch.ops import _kernels
    _kernels.reset_launch_counts()


def _launches(*names):
    """The launch counts of the kernels ``names`` (``_kernels.LAUNCHES``)."""
    from mpeg_pcc_tmc13_tpu_torch.ops import _kernels
    return {k: _kernels.LAUNCHES[k] for k in names}


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
    partial thread block), for reflectance and colour, and for 2 and 5
    channels, which the wrappers send through the same kernels in runs
    of 3 and 1 (one launch a run)."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import raht_blocks as rb
    errs = {"fwd_blocks": 0.0, "inv_blocks": 0.0}
    shapes = [(b, c) for c in (1, 3) for b in CHECK_BLOCKS]
    shapes += [(b, c) for c in SPLIT_CHANNELS for b in CHECK_BLOCKS[-2:]]
    for nblocks, nchan in shapes:
        v, w = _block_inputs(nblocks, nchan, nblocks + nchan, device)
        _reset_launches()
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
        _check(e_fwd == 0.0 and e_inv == 0.0
               and torch.equal(coeffs, rc) and torch.equal(back, rback),
               f"a block kernel differs from its plain version (B={nblocks}"
               f", C={nchan}): fwd {e_fwd}, inv {e_inv}")
        runs = len(rb.channel_groups(nchan))
        launches = _launches("fwd_blocks", "inv_blocks")
        _check(launches == {"fwd_blocks": runs, "inv_blocks": runs},
               f"C={nchan} took {launches} launches, not {runs} each")
        errs["fwd_blocks"] = max(errs["fwd_blocks"], e_fwd)
        errs["inv_blocks"] = max(errs["inv_blocks"], e_inv)
    _line("c", shapes=",".join(f"{b}x{c}" for b, c in shapes),
          patterns=256, mask_wout="identical",
          fwd_max_abs_err=errs["fwd_blocks"],
          inv_max_abs_err=errs["inv_blocks"], tol=0)
    _lane_channels_check(device)
    return errs


def _lane_channels_check(device, nchan=2, depth=8):
    """The float RAHT lane at a channel count the kernels are not built
    for, on the card: ``forward_device`` on (N, 2) values equals, bit for
    bit, the lane run on each channel alone (the kernels treat channels
    independently), with one launch per level and run of channels, and
    ``inverse_device`` gives the values back."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import raht_blocks as rb
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_device
    uniq, colors = bench_cloud(n=20_000, depth=depth)
    vals = colors[:, :nchan].astype(np.float32)
    staged = raht_device.stage_plan(uniq, depth, device)
    _reset_launches()
    acs, root = raht_device.forward_device(uniq, vals, depth, staged=staged)
    back = raht_device.inverse_device(uniq, acs, root, depth, staged=staged)
    launches = _launches("fwd_blocks", "inv_blocks")
    _sync(device)
    runs = len(rb.channel_groups(nchan)) * depth
    _check(launches == {"fwd_blocks": runs, "inv_blocks": runs},
           f"the C={nchan} lane took {launches} launches, not {runs} each")
    for ch in range(nchan):
        one, root1 = raht_device.forward_device(uniq, vals[:, ch], depth,
                                                staged=staged)
        _check(torch.equal(root[:, ch], root1[:, 0])
               and all(torch.equal(a[0][:, :, ch], b[0][:, :, 0])
                       and torch.equal(a[1], b[1])
                       for a, b in zip(acs, one)),
               f"channel {ch} of the C={nchan} lane differs from the lane "
               f"on that channel alone")
    err = float(np.abs(back.cpu().numpy() - vals).max())
    _check(root.device == device and back.shape == vals.shape
           and err < LANE_INVERSE_MAX,
           f"the C={nchan} lane's inverse is off by {err}")
    _line("c", lane_channels=nchan, points=uniq.size, depth=depth,
          vs_single_channel_lanes="identical",
          inverse_max_abs_err=err, tol=LANE_INVERSE_MAX,
          launches=json.dumps(launches, separators=(",", ":")))


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
    from mpeg_pcc_tmc13_tpu_torch.runtime import device_pipeline as dp
    from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt

    _default_device_check(device)
    _reset_launches()
    r = rt.device_roundtrip(uniq, depth, colors, qp=qp, device=device)
    launches = _launches("fwd_blocks", "inv_blocks", "octree_occ_u8",
                         "octree_expand", "raht_fp_truth_level",
                         "raht_fp_group", "raht_fp_plan")

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


def _equal_or_fail(name, got, want, where):
    """Max abs difference of two output tuples; fails unless every
    output is identical."""
    import torch
    got, want = _as_tuple(got), _as_tuple(want)
    err = _max_abs_diff(zip(got, want))
    _check(len(got) == len(want) and all(
        g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
        for g, w in zip(got, want)),
        f"{name} differs from its plain version {where}: max abs {err}")
    return err


def _fp_level_inputs(dv, vals):
    """The inputs of every truth level and every encode and decode group
    of ``dv`` on ``vals`` (N, C) int64, propagated with the plain
    versions on the card: [(args, kwargs)] each."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
    truth, enc, dec = [], [], []
    cur = vals << fpd.F
    acs = []
    for p in dv.plans:
        truth.append(((cur, p), {}))
        cur, z, y, x = fpd._truth_level_ref(cur, p)
        acs.append((z, y, x))
    recon = fpd._dequant(fpd._quant(cur, dv.steps), dv.steps)
    grand = torch.zeros(dv.n_roots, dtype=torch.int64, device=vals.device)
    for gi in range(dv.depth):
        p = dv.plans[dv.depth - 1 - gi]
        kw = dv._group_kw(gi)
        args = (recon, grand, *acs[dv.depth - 1 - gi], dv.steps, p)
        enc.append((args, kw))
        qz, qy, qx, rc, gr = fpd._enc_group_ref(*args, **kw)
        dec.append(((recon, grand, qz, qy, qx, dv.steps, p), kw))
        recon, grand = rc, gr
    return truth, enc, dec


def _expand_inputs(occ_u8, counts, depth, nmax):
    """Every level's (nodes, occ) inputs of the decoder expansion, from
    the plain version's chain on the card (occ int64, zero past the
    level's count, as the rANS decoder passes it)."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import octree
    dev = occ_u8.device
    tabs = (octree._nth_set_bit_table(dev), octree._popcount8_table(dev))
    row = torch.arange(nmax, dtype=torch.int64, device=dev)
    offs = torch.cumsum(counts, 0) - counts
    nodes = torch.full((nmax,), octree.I64_MAX, dtype=torch.int64,
                       device=dev)
    nodes[0] = 0
    out = []
    for l in range(depth):
        idx = (offs[l] + row).clamp(max=occ_u8.shape[0] - 1)
        occ = torch.where(row < counts[l], occ_u8[idx].to(torch.int64), 0)
        out.append((nodes, occ, nmax))
        nodes = octree._expand_level_ref(nodes, occ, nmax, *tabs)[0]
    return out, tabs


def phase_p(device, uniq, depth, colors, qp=BENCH_QP):
    """The headline path's four kernels against their plain versions on
    the card at the bench cloud's shapes, every level and group, max abs
    difference 0: ``octree_occ_u8`` at the pipeline's cap and at an
    undersized one (bytes below the cap and whole counts); the
    expansion per level (``_expand_level``, the rANS decoder's form) and
    as ``decode_expand_stream`` (the pipeline's form, every level in one
    call); ``raht_fp_truth_level`` at each of the 11 levels and
    ``raht_fp_group`` at each of the 11 encode and 11 decode groups,
    called alone (the parents' means computed per read), then both as
    ``DeviceFpRaht`` runs them (the roots (de)quantised in the first
    group, the means handed on, the last decode group shifting out the
    fraction) against the plain loop on one plan.  Returns the max abs
    differences and the inputs (f) times."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.models.attr_raht import qp_to_step_q16
    from mpeg_pcc_tmc13_tpu_torch.ops import octree
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd

    t_phase = time.perf_counter()
    errs = {}
    n = uniq.size
    codes = torch.as_tensor(uniq, device=device)
    cap = max(64, int(n * 2.3)) & ~63
    want = octree.encode_occ_u8_hdr_ref(codes, depth, cap)
    counts = want[:4 * depth].view(torch.int32).to(torch.int64)
    total = int(counts.sum())
    if total > cap:                    # the pipeline's retry, larger
        cap = max(64, int(total * 1.25)) & ~63
        want = octree.encode_occ_u8_hdr_ref(codes, depth, cap)
    errs["octree_occ_u8"] = _equal_or_fail(
        "octree_occ_u8", octree.encode_occ_u8_hdr(codes, depth, cap), want,
        "at the pipeline's cap")
    small = total // 2
    got = octree.encode_occ_u8(codes, depth, small)
    errs["octree_occ_u8"] = max(errs["octree_occ_u8"], _equal_or_fail(
        "octree_occ_u8", got, octree.encode_occ_u8_ref(codes, depth, small),
        f"at an undersized cap ({small} of {total} nodes)"))
    _check(int(got[1].to(torch.int64).sum()) == total,
           "undersized cap: the counts are not whole")
    occ_u8 = want[4 * depth:4 * depth + total].contiguous()
    levels, tabs = _expand_inputs(occ_u8, counts, depth, n)
    errs["octree_expand"] = max(
        _equal_or_fail("octree_expand", octree._expand_level(*a),
                       octree._expand_level_ref(*a, *tabs), f"at level {l}")
        for l, a in enumerate(levels))
    counts32 = counts.to(torch.int32)
    stream = (occ_u8, counts32, depth, n)
    got = octree.decode_expand_stream(*stream)
    errs["octree_expand"] = max(errs["octree_expand"], _equal_or_fail(
        "octree_expand", got, octree.decode_expand_stream_ref(*stream),
        "as decode_expand_stream"))
    _check(np.array_equal(got[0][:n].cpu().numpy(), uniq),
           "the expansion does not give the input codes back")
    errs["octree_expand"] = max(errs["octree_expand"],
                                _expand_edge_checks(uniq, depth, stream,
                                                    device))

    steps = [qp_to_step_q16(qp)] * colors.shape[1]
    t0 = time.perf_counter()
    dv = fpd.DeviceFpRaht(uniq, depth, steps, device=device)
    plan_s = time.perf_counter() - t0
    vals = torch.as_tensor(colors, dtype=torch.int64, device=device)
    truth, enc, dec = _fp_level_inputs(dv, vals)
    for key, kern, ref, cases in (
            ("raht_fp_truth_level", fpd._truth_level, fpd._truth_level_ref,
             truth),
            ("raht_fp_group", fpd._enc_group, fpd._enc_group_ref, enc),
            ("raht_fp_group", fpd._dec_group, fpd._dec_group_ref, dec)):
        err = max(_equal_or_fail(key, kern(*a, **kw), ref(*a, **kw),
                                 f"({kern.__name__} at step {i})")
                  for i, (a, kw) in enumerate(cases))
        errs[key] = max(errs.get(key, 0.0), err)
    # the modes of the main path: DeviceFpRaht's kernel loop, one plan
    # (a CPU rehearsal runs the kernels' mirrors in their place)
    launchers = fpd.CUDA_LAUNCHERS if device.type == "cuda" else \
        fpd.MIRROR_LAUNCHERS
    rec_k, qbuf = dv._encode_kernels(vals, launchers)
    plain_q = []
    rec_p = dv._encode_plain(vals, plain_q.append)
    host = qbuf.cpu().numpy()
    cuts = dv.rows.slices()
    _check(all(np.array_equal(host[c], q) for c, q in zip(cuts, plain_q)),
           "DeviceFpRaht's kernel loop gives other q rows than the plain "
           "loop")
    rows = torch.as_tensor(np.concatenate(plain_q).astype(np.int64),
                           device=device)
    dec_k = dv._decode_kernels(rows, launchers)
    dec_p = dv._decode_plain(rows, [c.stop - c.start for c in cuts])
    errs["raht_fp_group"] = max(errs["raht_fp_group"], _equal_or_fail(
        "raht_fp_group", (rec_k, dec_k), (rec_p, dec_p),
        "in DeviceFpRaht's loop"))
    if device.type == "cuda":
        errs["raht_fp_group"] = max(errs["raht_fp_group"],
                                    _group_division_checks(dv, vals, enc,
                                                           rows))
    errs["raht_fp_group"] = max(errs["raht_fp_group"],
                                _group_wide_checks(dv, vals, launchers))
    errs["raht_fp_plan"] = _plan_checks(codes, uniq, depth)
    _sync(device)
    _line("p", occ_u8_caps=f"{cap},{small}", nodes=total,
          expand_levels=depth, truth_levels=len(truth), enc_groups=len(enc),
          dec_groups=len(dec), q_rows=int(host.shape[0]),
          max_abs_err=json.dumps(errs, separators=(",", ":")), tol=0,
          plan_s=f"{plan_s:.1f}",
          phase_s=f"{time.perf_counter() - t_phase:.1f}")
    return errs, SimpleNamespace(codes=codes, cap=cap, stream=stream,
                                 expand_levels=levels, expand_tabs=tabs,
                                 truth=truth, enc=enc, dec=dec, dv=dv,
                                 vals=vals, rows=rows)


def _expand_edge_checks(uniq, depth, stream, device):
    """``octree_expand`` against ``decode_expand_stream_ref`` on a stream
    whose first levels hold one node each (the bench cloud's points in
    the level-3 node of its first point) at nmax exactly (the last level
    fills it) and with room to spare.  Returns the max abs difference."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import octree
    shift = 3 * (depth - 3)
    corner = uniq[(uniq >> shift) == (uniq[0] >> shift)]
    codes = torch.as_tensor(corner, device=device)
    hdr = octree.encode_occ_u8_hdr_ref(codes, depth,
                                       depth * corner.size + 64)
    counts = hdr[:4 * depth].view(torch.int32)
    _check(counts[:4].tolist() == [1, 1, 1, 1],
           f"(p) the corner stream's first levels: {counts[:4].tolist()}")
    occ = hdr[4 * depth:].contiguous()
    err = 0
    for nmax in (corner.size, corner.size + 37):
        err = max(err, _equal_or_fail(
            "octree_expand",
            octree.decode_expand_stream(occ, counts, depth, nmax),
            octree.decode_expand_stream_ref(occ, counts, depth, nmax),
            f"on one-node first levels, nmax {nmax}"))
    _line("p", kernel="octree_expand", corner_points=corner.size,
          corner_counts=counts.tolist(), nmax_exact="identical",
          nmax_spare="identical")
    return err


def _group_call_stats(args, kw, decode, stats):
    """``_enc_group``/``_dec_group``'s launch with a division count."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_plan as rp
    recon_p, grand_p, r0, r1, r2, steps, p = args
    mp, mc, counts = fpd._group_shapes(p)
    c = steps.shape[0]
    recon_c = recon_p.new_empty(mc, c)
    cnt = recon_p.new_empty(mc)
    q = [None] * 3 if decode else [recon_p.new_empty(n, c) for n in counts]
    mode = (fpd.MODE_DECODE if decode else 0) | \
        (fpd.MODE_HAVE_GRAND if kw["have_grand"] else 0)
    fpd._cuda_group(p, rp.row_offsets(p), mp, mode, recon_p, None,
                    grand_p if kw["have_grand"] else None, steps,
                    [r0, r1, r2], None, q, None, recon_c, None, cnt,
                    kw["t0"], kw["weights"], stats=stats)
    return (*q, recon_c, cnt) if not decode else (recon_c, cnt)


def _group_division_checks(dv, vals, enc, rows):
    """The division paths of ``raht_fp_group``: the kernel's count of
    fast and general divisions over ``DeviceFpRaht``'s 11 encode and 11
    decode groups (the main path), and a group whose parents'
    reconstruction holds values of +-2^62 in every 5th row (their Q15
    shifts wrap: the general path) held to ``_enc_group_ref`` and
    ``_dec_group_ref``.  Returns the max abs difference."""
    import functools

    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
    dev = vals.device
    main = torch.zeros(2, dtype=torch.int64, device=dev)
    launch = functools.partial(fpd._cuda_group, stats=main)
    truth = dv._truth_kernels(vals, fpd.CUDA_LAUNCHERS)
    dv._enc_group_kernels(*truth, (fpd._cuda_truth, launch))
    dv._decode_kernels(rows, (fpd._cuda_truth, launch))
    args, kw = enc[len(enc) // 2]
    g = torch.Generator(device=dev).manual_seed(62)
    big = args[0].clone()
    big[::5] = torch.randint(-(1 << 62), 1 << 62, big[::5].shape,
                             generator=g, device=dev)
    a = (big,) + tuple(args[1:])
    extreme = torch.zeros(2, dtype=torch.int64, device=dev)
    err = _equal_or_fail("raht_fp_group",
                         _group_call_stats(a, kw, False, extreme),
                         fpd._enc_group_ref(*a, **kw),
                         "on parents of +-2^62 (encode)")
    qz, qy, qx = fpd._enc_group_ref(*a, **kw)[:3]
    d = (big, a[1], qz, qy, qx, a[5], a[6])
    err = max(err, _equal_or_fail(
        "raht_fp_group", _group_call_stats(d, kw, True, extreme),
        fpd._dec_group_ref(*d, **kw), "on parents of +-2^62 (decode)"))
    main, extreme = main.tolist(), extreme.tolist()
    _check(extreme[1] > 0, "(p) the extreme group took no general-path "
           "division")
    _line("p", kernel="raht_fp_group", main_path_divisions_fast=main[0],
          main_path_divisions_general=main[1],
          extreme_group_blocks=int(a[6]["az"].shape[0]),
          extreme_divisions_fast=extreme[0],
          extreme_divisions_general=extreme[1], vs_ref="identical")
    return err


def _group_wide_checks(dv, vals, launchers, nc=5):
    """``DeviceFpRaht``'s loop at ``nc`` > ``GROUP_WINDOW`` channels (the
    group kernel's windows after the first gather their means again and
    read their input rows from global memory) on ``dv``'s plan: the
    colours and two channels more from them, steps from qp 22 and 28,
    against the plain loop.  Returns the max abs difference."""
    import copy

    import torch

    from mpeg_pcc_tmc13_tpu_torch.models.attr_raht import qp_to_step_q16
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
    _check(nc > fpd.GROUP_WINDOW, "the wide case needs two windows")
    wide = copy.copy(dv)
    extra = nc - vals.shape[1]
    wide.steps = torch.cat([dv.steps, torch.full(
        (extra,), qp_to_step_q16(28), dtype=torch.int64,
        device=dv.steps.device)])
    wvals = torch.cat([vals, (vals[:, :extra] * 7 + 3) % 256], 1)
    rec_k, qbuf = wide._encode_kernels(wvals, launchers)
    plain_q = []
    rec_p = wide._encode_plain(wvals, plain_q.append)
    host = qbuf.cpu().numpy()
    cuts = wide.rows.slices()
    _check(all(np.array_equal(host[c], q) for c, q in zip(cuts, plain_q)),
           f"(p) the group kernel at {nc} channels gives other q rows than "
           "the plain loop")
    rows = torch.as_tensor(np.concatenate(plain_q).astype(np.int64),
                           device=wvals.device)
    err = _equal_or_fail(
        "raht_fp_group",
        (rec_k, wide._decode_kernels(rows, launchers)),
        (rec_p, wide._decode_plain(rows, [c.stop - c.start for c in cuts])),
        f"in DeviceFpRaht's loop at {nc} channels")
    _line("p", kernel="raht_fp_group", channels=nc,
          windows=-(-nc // fpd.GROUP_WINDOW), q_rows=int(host.shape[0]),
          vs_plain_loop="identical")
    return err


def _level_record(occ2, ctx2, counts, states0, words, K):
    """(g)'s decode rebuilt level by level with the plain version from
    the encoder's analysis rows (each level's context row is ``ctx2``'s,
    padded): the inputs of every ``decode_level`` call, the running state
    (lane states, cursor, histogram, table) at every level's start and
    after the last one (depth + 1 tables), and each level's symbols."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import rans_lanes as L
    nmax = occ2.shape[1]
    nmax_p = (-(-nmax // K) + 1) * K
    dev = occ2.device
    hist = torch.zeros(L.N_CTX * 256, dtype=torch.int32, device=dev)
    state = (states0.clone(), torch.zeros(1, dtype=torch.int64, device=dev),
             hist, L.quantize_tables_ref(hist.view(L.N_CTX, 256)).view(-1))
    rec = SimpleNamespace(
        ctx_rows=[torch.nn.functional.pad(ctx2[l], (0, nmax_p - nmax))
                  for l in range(occ2.shape[0])],
        counts=list(counts), words=words, K=K, nmax_p=nmax_p,
        starts=[tuple(t.clone() for t in state)], syms=[])
    states, cursor, hist, table = state
    for ctx_row, count in zip(rec.ctx_rows, rec.counts):
        syms = torch.zeros(nmax_p, dtype=torch.int32, device=dev)
        L.decode_level_ref(table, ctx_row, words, states, cursor, syms, hist,
                           count)
        rec.starts.append(tuple(t.clone() for t in state))
        rec.syms.append(syms)
    return rec


def _new_level_state(rec):
    """Working buffers for ``_replay_levels``: (states, cursor, hist,
    table, one symbol row per level)."""
    import torch
    return (*(torch.empty_like(t) for t in rec.starts[0]),
            [torch.zeros(rec.nmax_p, dtype=torch.int32,
                         device=rec.words.device) for _ in rec.counts])


def _replay_levels(fn, rec, state):
    """Run ``fn`` (decode_level or its plain version) over every level
    of the recorded decode from its initial state, which is copied into
    ``state`` first."""
    states, cursor, hist, table, syms = state
    for t, t0 in zip(state[:4], rec.starts[0]):
        t.copy_(t0)
    for l, (ctx_row, count) in enumerate(zip(rec.ctx_rows, rec.counts)):
        fn(table, ctx_row, rec.words, states, cursor, syms[l], hist, count)
    return state


def _decode_level_check(fn, rec, device):
    """``fn`` against the recorded plain decode at every level, each
    level from the recorded state at its start: states, cursor, hist,
    table and symbols by ``torch.equal``.  Returns the largest absolute
    difference (0); fails at the first level that differs."""
    import torch
    err = 0.0
    for l, (ctx_row, count) in enumerate(zip(rec.ctx_rows, rec.counts)):
        states, cursor, hist, table = (t.clone() for t in rec.starts[l])
        syms = torch.zeros(rec.nmax_p, dtype=torch.int32,
                           device=rec.words.device)
        fn(table, ctx_row, rec.words, states, cursor, syms, hist, count)
        _sync(device)
        got = (states, cursor, hist, table, syms)
        want = (*rec.starts[l + 1], rec.syms[l])
        err = max(err, _max_abs_diff(zip(got, want)))
        _check(all(torch.equal(a, b) for a, b in zip(got, want)),
               f"decode_level differs from its plain version at level {l} "
               f"(K={rec.K}, count={count}): max abs {err}")
    return err


def _wide_row_check(rec, device, occurrences=WIDE_ROW_OCCURRENCES):
    """Both kernels on context rows of more than 2^23 counts, where
    their quantisation takes its second branch (a double reciprocal):
    ``decode_level`` at the recorded decode's largest level, from the
    state at its start with the level's three busiest rows raised by
    about 2^24 counts each and the table rebuilt from them; and
    ``table_pass`` on one level of ``occurrences`` random symbols in one
    context row.  Each against its plain version by ``torch.equal``.
    Returns (the max abs differences, the raised rows' smallest count
    total, the table-pass row's count total)."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import rans_lanes as L
    rng = np.random.default_rng(23)
    l = max(range(len(rec.counts)), key=rec.counts.__getitem__)
    count = rec.counts[l]
    rows = torch.bincount(rec.ctx_rows[l][:count].long(),
                          minlength=L.N_CTX).topk(3).indices
    states, cursor, hist, _ = (t.clone() for t in rec.starts[l])
    h = hist.view(L.N_CTX, 256)
    h[rows, 1:] += torch.as_tensor(rng.integers(0, 1 << 17, (3, 255)),
                                   dtype=torch.int32, device=h.device)
    wide = int((h[rows, 1:].long() + 1).sum(1).min())
    start = (states, cursor, hist, L.quantize_tables_ref(h).view(-1))
    outs = []
    for fn in (L.decode_level, L.decode_level_ref):
        st, cur, hi, table = (t.clone() for t in start)
        syms = torch.zeros(rec.nmax_p, dtype=torch.int32, device=hi.device)
        fn(table, rec.ctx_rows[l], rec.words, st, cur, syms, hi, count)
        outs.append((st, cur, hi, table, syms))
    _sync(device)
    errs = {"decode_level": _max_abs_diff(zip(*outs))}
    _check(all(torch.equal(a, b) for a, b in zip(*outs)),
           f"decode_level differs from its plain version on rows of "
           f"{wide} counts: max abs {errs['decode_level']}")
    occ = torch.as_tensor(rng.integers(1, 256, (1, occurrences)),
                          dtype=torch.int32, device=hist.device)
    ctx = torch.full_like(occ, int(rows[0]))
    got = L.table_pass(occ, ctx, [occurrences], rec.K)
    want = L.table_pass_ref(occ, ctx, [occurrences], rec.K)
    _sync(device)
    errs["table_pass"] = _max_abs_diff(zip(got, want))
    _check(all(torch.equal(a, b) for a, b in zip(got, want)),
           f"table_pass differs from its plain version on a row of "
           f"{occurrences} occurrences: max abs {errs['table_pass']}")
    return errs, wide, occurrences + 255


def _host_spec_plan(uniq, depth, device):
    """The host planner's plan on ``device``: ``build_fp_plan``, then
    ``plans_to_torch`` and ``row_offsets``, as a ``FramePlan``."""
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_plan as rp
    host = fpd.build_fp_plan(uniq, depth)
    plans = fpd.plans_to_torch(host, device)
    return rp.FramePlan(
        plans, [rp.row_offsets(q) for q in plans],
        [(h.flat_z.size, h.flat_y.size, h.flat_x.size) for h in host],
        host[-1].mp if host else uniq.size)


def _plan_checks(codes, uniq, depth):
    """``build_plan``'s kernels on the bench cloud's codes against its
    plain version ``build_plan_ref`` on the card and against the host
    spec, every level's tensors and row offsets (dtype, shape, values)
    and the counts; every tensor 16-byte aligned.  Returns the max abs
    difference, which must be 0."""
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_plan as rp
    got = rp.build_plan(codes, depth)
    _check(len(got.plans) == depth, f"build_plan gave {len(got.plans)} "
           f"levels, not {depth}")
    err = 0.0
    for what, want in (
            ("build_plan_ref", rp.build_plan_ref(codes, depth)),
            ("the host spec", _host_spec_plan(uniq, depth, codes.device))):
        _check((got.n_roots, got.pair_counts, len(got.plans))
               == (want.n_roots, want.pair_counts, len(want.plans)),
               f"build_plan's counts differ from {what}'s")
        for g, (a, b) in enumerate(zip(got.plans, want.plans)):
            _check(a.keys() == b.keys(), f"build_plan's level {g} holds "
                   f"other tensors than {what}'s")
            keys = sorted(b)
            err = max(err, _equal_or_fail(
                "raht_fp_plan", tuple(a[k] for k in keys) + got.offsets[g],
                tuple(b[k] for k in keys) + want.offsets[g],
                f"({what}, level {g})"))
    _check(all(t.data_ptr() % 16 == 0 and t.is_contiguous()
               for p, offs in zip(got.plans, got.offsets)
               for t in list(p.values()) + list(offs)),
           "a plan tensor of build_plan is not 16-byte aligned")
    return err


def _max_abs_diff(pairs):
    return max(float((a.to(float) - b.to(float)).abs().max())
               if a.numel() else 0.0 for a, b in pairs)


def _busiest_row(occ2, ctx2, counts, K):
    """(context row, occurrences, windows) of the row with the most
    occurrences: the table pass kernel's longest chain."""
    from mpeg_pcc_tmc13_tpu_torch.ops import rans_lanes as L
    _, win, _, row_off = L.table_pass_groups(occ2, ctx2, counts, K)
    sizes = (row_off[1:] - row_off[:-1]).tolist()
    row = max(range(len(sizes)), key=sizes.__getitem__)
    lo, hi = int(row_off[row]), int(row_off[row + 1])
    return row, sizes[row], int(win[lo:hi].unique().numel())


def _rans_case(device, uniq, depth, payload):
    """The rANS kernels held to their plain versions on one cloud, at
    the shapes the main path gave them: the plain versions' payload
    (``payload`` is the main path's brick) and decode on the card, then
    ``table_pass``'s three outputs, ``encode_emit``'s three and
    ``decode_level``'s five at every level by ``torch.equal``.  Returns
    (the kernels' inputs for (f), the max abs differences)."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.models import geometry_rans as gr
    from mpeg_pcc_tmc13_tpu_torch.ops import octree_rans as R
    from mpeg_pcc_tmc13_tpu_torch.ops import rans_lanes as L
    n = uniq.size
    nmax = gr._bucket(n)
    K = min(gr._lanes_for(n), nmax)
    _check(payload[0] == K.bit_length() - 1,
           f"the brick codes {1 << payload[0]} lanes, not {K}")
    leaf = np.empty(nmax, dtype=np.int64)
    leaf[:n] = uniq
    leaf[n:] = uniq[-1]
    leaf_d = torch.as_tensor(leaf, device=device)
    buf, _ = R.encode_device(leaf_d, depth, nmax, K, plain=True)
    _check(buf.cpu().numpy().tobytes() == payload[1:],
           f"rANS payload differs from the plain versions' (K={K})")
    counts, states, words = R.parse_payload(
        np.frombuffer(payload, np.uint8)[1:], depth, K)
    wp = np.zeros(gr._bucket(max(64, words.shape[0])), np.int32)
    wp[:words.shape[0]] = words
    states0 = torch.as_tensor(states.astype(np.int64), device=device)
    words_d = torch.as_tensor(wp, device=device)
    nodes, cnt = R.decode_device(counts, states0, words_d, depth, nmax, K,
                                 plain=True)
    _check(np.array_equal(nodes[:int(cnt)].cpu().numpy(), uniq),
           f"the plain rANS decode differs from the input (K={K})")

    occ2, ctx2, cnt_d = R._analysis(leaf_d, depth, nmax)
    counts = cnt_d.tolist()
    want = L.table_pass_ref(occ2, ctx2, counts, K)
    got = L.table_pass(occ2, ctx2, counts, K)
    _sync(device)
    errs = {"table_pass": _max_abs_diff(zip(got, want))}
    _check(all(torch.equal(a, b) for a, b in zip(got, want)),
           f"table_pass differs from its plain version (K={K})")
    f_steps, c_steps, hist = want
    nvalid = torch.as_tensor(R._nvalid(counts, K), device=device)
    got = L.encode_emit(f_steps, c_steps, nvalid)
    want = L.encode_emit_ref(f_steps, c_steps, nvalid)
    _sync(device)
    errs["encode_emit"] = _max_abs_diff(zip(got, want))
    _check(all(torch.equal(a, b) for a, b in zip(got, want)),
           f"encode_emit differs from its plain version (K={K})")
    rec = _level_record(occ2, ctx2, counts, states0, words_d, K)
    _check(int(rec.starts[-1][1]) == words.shape[0]
           and torch.equal(rec.syms[-1][:counts[-1]],
                           occ2[-1, :counts[-1]]),
           f"the recorded levels do not replay the decode (K={K})")
    errs["decode_level"] = _decode_level_check(L.decode_level, rec, device)
    run = SimpleNamespace(
        occ2=occ2, ctx2=ctx2, counts=counts, K=K, f_steps=f_steps,
        c_steps=c_steps, nvalid=nvalid, hist=hist, rec=rec,
        busiest=_busiest_row(occ2, ctx2, counts, K),
        windows=len(L.windows(counts, K)))
    return run, errs


def _emit_shapes_check(run, device, lanes=EMIT_RAGGED_LANES):
    """``encode_emit`` against its plain version at the shapes its slabs
    and blocks divide unevenly, cut from the run's table pass: ``lanes``
    lanes (no multiple of a block's 32, so the last block is ragged)
    over every step, fewer steps than one slab, one lane, and no step at
    all.  Returns (the max abs difference, the shapes as text)."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import rans_lanes as L
    G, K = run.f_steps.shape
    _check(lanes % 32 and lanes < K, f"{lanes} lanes do not cut {K} raggedly")
    # the kernel's table of magic numbers (from a double division) against
    # the integer formula, for every frequency
    m, inc, _ = L.emit_reciprocal(np.arange(1, L.M + 1))
    want = (m & np.uint64(0x7FFFFFFF)) | (inc << np.uint64(31))
    got = L.emit_magic_table(device)[1:].cpu().numpy().astype(np.uint64)
    _check(np.array_equal(got, want),
           f"{int((got != want).sum())} magic numbers differ from the "
           f"integer formula")
    err, shapes = 0.0, []
    for steps, k in ((G, lanes), (5, lanes), (G // 8, 1), (0, 33)):
        args = (run.f_steps[:steps, :k].contiguous(),
                run.c_steps[:steps, :k].contiguous(),
                run.nvalid[:steps].clamp(max=k))
        got, want = L.encode_emit(*args), L.encode_emit_ref(*args)
        _sync(device)
        err = max(err, _max_abs_diff(zip(got, want)))
        _check(all(torch.equal(a, b) for a, b in zip(got, want)),
               f"encode_emit differs from its plain version at {steps} "
               f"steps of {k} lanes: max abs {err}")
        shapes.append(f"{steps}x{k}")
    return err, ",".join(shapes)


def phase_g(device, uniq, depth, range_coded_bytes):
    """The rANS brick at the bench size through geometry_rans on the
    card: one table-pass launch per encode and one decode launch per
    level, the decoded codes equal the input, the payload equals the
    plain versions', and each kernel equals its plain version at this
    run's shapes and on context rows past 2^23 counts; then the same
    checks on two small slices (K = 64 and 256, as the CLI's small slices
    code)."""
    from mpeg_pcc_tmc13_tpu_torch.models import geometry_rans as gr
    from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt
    from mpeg_pcc_tmc13_tpu_torch.utils import morton

    pos = morton.decode(uniq)
    _sync(device)
    _reset_launches()
    t0 = time.perf_counter()
    payload = gr.encode(pos, depth, device=device)
    t1 = time.perf_counter()
    out = gr.decode(payload, uniq.size, depth, device=device)
    t2 = time.perf_counter()
    launches = _launches(*RANS_KERNELS)
    _check(launches == {"table_pass": 1, "encode_emit": 1,
                        "decode_level": depth},
           f"the rANS path did not launch one table pass, one emission "
           f"and one decode per level: {launches}")
    _check(np.array_equal(morton.encode(out), uniq),
           "rANS decoded codes differ from the input")
    run, errs = _rans_case(device, uniq, depth, payload)
    run.payload, run.encode_s, run.decode_s = payload, t1 - t0, t2 - t1
    wide_errs, wide, pass_total = _wide_row_check(run.rec, device)
    _check(min(wide, pass_total) >= 1 << 23,
           f"the wide rows hold {wide} and {pass_total} counts, not 2^23")
    for k, v in wide_errs.items():
        errs[k] = max(errs[k], v)
    _line("g", wide_rows="decode_level_3_rows,table_pass_1_row",
          decode_level_row_counts_min=wide,
          table_pass_row_counts=pass_total, over=1 << 23,
          kernels_vs_plain=json.dumps(wide_errs, separators=(",", ":")))
    emit_err, emit_shapes = _emit_shapes_check(run, device)
    errs["encode_emit"] = max(errs["encode_emit"], emit_err)
    _line("g", encode_emit_steps_x_lanes=emit_shapes, vs_plain="identical",
          max_abs_err=emit_err, tol=0,
          magic_numbers_vs_integer_formula="identical_x16384")
    row, occs, wins = run.busiest
    _line("g", points=uniq.size, depth=depth, lanes=run.K,
          steps=run.f_steps.shape[0], windows=run.windows,
          rans_bytes=len(payload), range_coded_bytes=range_coded_bytes,
          rans_over_range_coded=f"{len(payload) / range_coded_bytes:.4f}",
          payload_vs_plain="identical", decoded_codes="identical",
          kernels_vs_plain=json.dumps(errs, separators=(",", ":")),
          busiest_row=row, busiest_row_occurrences=occs,
          busiest_row_windows=wins,
          encode_s=f"{run.encode_s:.4f}", decode_s=f"{run.decode_s:.4f}",
          launches=json.dumps(launches, separators=(",", ":")))
    for n, d in ((5_000, 8), (20_000, 9)):
        small = rt.sorted_unique_codes(rt.make_surface_cloud(n, d))
        small_run, small_errs = _rans_case(
            device, small, d, gr.encode(morton.decode(small), d,
                                        device=device))
        for k, v in small_errs.items():
            errs[k] = max(errs[k], v)
        _line("g", points=small.size, depth=d, lanes=small_run.K,
              steps=small_run.f_steps.shape[0], windows=small_run.windows,
              payload_vs_plain="identical",
              kernels_vs_plain=json.dumps(small_errs, separators=(",", ":")))
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


def _cli_process(args):
    """Run the port's CLI as the command a user runs, in a process of
    its own: (wall s of the process, its stdout)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mpeg_pcc_tmc13_tpu_torch.runtime.cli",
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)
    secs = time.perf_counter() - t0
    _check(res.returncode == 0,
           f"the CLI process failed ({res.returncode}):\n{res.stderr}")
    return secs, res.stdout


def _cli_number(out, pattern):
    m = re.search(pattern, out)
    _check(m is not None, f"no {pattern!r} in the CLI's output")
    return m.group(1)


def _cli_wall(out):
    """The CLI's own "Processing time (wall)", seconds, as printed."""
    return _cli_number(out, r"Processing time \(wall\): ([\d.]+)")


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


@contextlib.contextmanager
def _analysis_devices(analysed):
    """Append the torch device type of every ``engine="device"`` octree
    analysis to ``analysed`` while the block runs."""
    from mpeg_pcc_tmc13_tpu_torch.ops import octree
    packed = octree.encode_analysis_packed

    def spy(codes, *a, **k):
        analysed.append(codes.device.type)
        return packed(codes, *a, **k)

    octree.encode_analysis_packed = spy
    try:
        yield
    finally:
        octree.encode_analysis_packed = packed


def phase_k(device, uniq, depth, colors, smi):
    """The port's CLI at the bench size, each geometry engine on the
    default device of the run (on the card no --device is given)."""
    from mpeg_pcc_tmc13_tpu_torch.models import attributes

    extra = [] if device.type == "cuda" else [f"--device={device}"]
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    src = CLI_DIR / "bench.ply"
    _write_cloud(src, uniq, colors)
    analysed = []
    runs = {}
    with _analysis_devices(analysed):
        for engine in ("native", "device", "rans"):
            bin_path = CLI_DIR / f"{engine}.bin"
            rec = CLI_DIR / f"{engine}.ply"
            analysed.clear()
            attr_s = {}
            _sync(device)
            _reset_launches()
            with _timed(attributes, "encode", attr_s):
                enc_s, enc_out = _cli(
                    ["--mode=0", f"--uncompressedDataPath={src}",
                     f"--compressedStreamPath={bin_path}",
                     f"--geomEngine={engine}", *CLI_FLAGS, *extra])
            enc_launches = _launches(*RANS_KERNELS)
            _reset_launches()
            with _timed(attributes, "decode", attr_s):
                dec_s, dec_out = _cli(
                    ["--mode=1", f"--compressedStreamPath={bin_path}",
                     f"--reconstructedDataPath={rec}", *extra])
            dec_launches = _launches(*RANS_KERNELS)
            runs[engine] = SimpleNamespace(
                stream=bin_path.read_bytes(), colors=_decoded(rec, uniq),
                bricks=_attribute_bricks(bin_path), analysed=list(analysed),
                enc_launches=enc_launches, dec_launches=dec_launches)
            _line("k", engine=engine, points=uniq.size,
                  encode_s=f"{enc_s:.3f}",
                  encode_cli_wall_s=_cli_wall(enc_out),
                  attr_encode_s=f"{attr_s['encode']:.3f}",
                  decode_s=f"{dec_s:.3f}",
                  decode_cli_wall_s=_cli_wall(dec_out),
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
           and rans.dec_launches["decode_level"] > 0,
           f"a rANS kernel was not launched under the CLI: {total}")

    # the rANS stream decoded by the command a user runs
    sub = CLI_DIR / "rans_subprocess.ply"
    sub_s, sub_out = _cli_process(
        ["--mode=1", f"--compressedStreamPath={CLI_DIR / 'rans.bin'}",
         f"--reconstructedDataPath={sub}", *extra])
    _check(sub.read_bytes() == (CLI_DIR / "rans.ply").read_bytes(),
           "the CLI process decoded another PLY than the in-process one")
    _line("k", device_vs_native_stream="identical",
          positions="unique_input_x3", colors="equal_x3",
          attribute_bricks=("identical_x3" if nat.bricks == dev.bricks
                            == rans.bricks else "differ"),
          rans_launches=json.dumps(total, separators=(",", ":")),
          subprocess_decode_s=f"{sub_s:.3f}",
          subprocess_cli_wall_s=_cli_wall(sub_out),
          subprocess_ply="identical", card=repr(smi))
    return total


def _write_cloud(path, uniq, colors):
    from mpeg_pcc_tmc13_tpu_torch import host
    from mpeg_pcc_tmc13_tpu_torch.utils import morton
    host.ply.write(host.ply.PlyCloud(
        positions=morton.decode(uniq).astype(np.float64), colors=colors),
        str(path))


def _sha256(path):
    import hashlib
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _encode_and_decode_twice(tag, src, flags, extra):
    """Encode ``src`` with ``flags`` in this process, decode the stream
    here and in a process of its own (no --refSyntax: the family is read
    from the SPS), and hold the two PLYs to each other.  Returns the
    stream's path, the in-process PLY's path and the printed line's
    timing and size fields."""
    bin_path = CLI_DIR / f"{tag}.bin"
    rec, sub = CLI_DIR / f"{tag}.ply", CLI_DIR / f"{tag}_subprocess.ply"
    enc_s, enc_out = _cli(["--mode=0", f"--uncompressedDataPath={src}",
                           f"--compressedStreamPath={bin_path}", *flags,
                           *extra])
    dec_s, dec_out = _cli(["--mode=1", f"--compressedStreamPath={bin_path}",
                           f"--reconstructedDataPath={rec}", *extra])
    sub_s, sub_out = _cli_process(
        ["--mode=1", f"--compressedStreamPath={bin_path}",
         f"--reconstructedDataPath={sub}", *extra])
    _check(sub.read_bytes() == rec.read_bytes(),
           f"{tag}: the CLI process decoded another PLY than this one")
    return bin_path, rec, dict(
        encode_cli_wall_s=_cli_wall(enc_out),
        decode_cli_wall_s=_cli_wall(dec_out),
        subprocess_cli_wall_s=_cli_wall(sub_out),
        subprocess_s=f"{sub_s:.3f}",
        geom_bytes=_cli_number(enc_out,
                               r"positions bitstream size (\d+) B"),
        color_bytes=_cli_number(enc_out, r"colors bitstream size (\d+) B"),
        stream_bytes=bin_path.stat().st_size, sha256=_sha256(bin_path),
        subprocess_ply="identical")


def _check_pinned(tag, bin_path, size, sha):
    _check(bin_path.stat().st_size == size and _sha256(bin_path) == sha,
           f"{tag}: {bin_path.stat().st_size} B, sha256 "
           f"{_sha256(bin_path)}; the JAX CLI writes {size} B, {sha}")


def _max_chebyshev(points, source, device, limit):
    """The largest Chebyshev distance from a row of ``points`` to its
    nearest row of ``source`` (both (N, 3) non-negative integers below
    2^20), exact: each ring of offsets in turn, by binary search in the
    sorted source keys.  Fails if a point has no source point within
    ``limit``."""
    import torch

    def keys(p):
        p = p + limit
        return (p[..., 0] << 42) | (p[..., 1] << 21) | p[..., 2]

    src = torch.unique(keys(torch.as_tensor(source, device=device)))
    left = torch.as_tensor(points, device=device)
    worst = 0
    for r in range(limit + 1):
        if left.shape[0] == 0:
            break
        side = torch.arange(-r, r + 1, device=device)
        ring = torch.cartesian_prod(side, side, side).reshape(-1, 3)
        ring = ring[ring.abs().amax(dim=1) == r]
        found = torch.zeros(left.shape[0], dtype=torch.bool, device=device)
        step = max(1, (1 << 24) // left.shape[0])
        for i in range(0, ring.shape[0], step):
            k = keys(left[None, :, :] + ring[i:i + step, None, :])
            at = torch.searchsorted(src, k).clamp(max=src.shape[0] - 1)
            found |= (src[at] == k).any(dim=0)
        if bool(found.any()):
            worst = r
        left = left[~found]
    _check(left.shape[0] == 0,
           f"{left.shape[0]} decoded points lie more than {limit} voxels "
           f"from every source point")
    return worst


@contextlib.contextmanager
def _spied(module, name, calls):
    """Append ``(return value, seconds)`` of every call of
    ``module.name`` to ``calls`` while the block runs."""
    fn = getattr(module, name)

    def spy(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        calls.append((out, time.perf_counter() - t0))
        return out

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, fn)


def phase_l(device, uniq, colors, smi, v2_points=TRISOUP_V2_POINTS,
            v2_depth=TRISOUP_V2_DEPTH, pinned=True):
    """The rest of the port's CLI: the tmc3 syntax family and trisoup
    geometry.  ``pinned=False`` (a rehearsal on another cloud) skips the
    comparisons with the JAX CLI's sizes, hashes and count."""
    from mpeg_pcc_tmc13_tpu_torch import host
    from mpeg_pcc_tmc13_tpu_torch.models import geometry_trisoup
    from mpeg_pcc_tmc13_tpu_torch.ops import trisoup as trisoup_ops
    from mpeg_pcc_tmc13_tpu_torch.runtime import cli
    from mpeg_pcc_tmc13_tpu_torch.utils import morton

    t0 = time.perf_counter()
    extra = [] if device.type == "cuda" else [f"--device={device}"]
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    src = CLI_DIR / "bench.ply"
    _write_cloud(src, uniq, colors)
    source = morton.decode(uniq)

    # the tmc3 syntax family, full size: a host path, no device asked for
    for tag, (flags, size, sha) in REF_SYNTAX_RUNS.items():
        bin_path, rec, fields = _encode_and_decode_twice(tag, src, flags, [])
        _check(cli.detect_ref_syntax(str(bin_path)),
               f"{tag}: the stream is not of the tmc3 syntax family")
        _decoded(rec, uniq)
        if pinned:
            _check_pinned(tag, bin_path, size, sha)
        _line("l", run=tag, points=uniq.size, positions="unique_input",
              **fields)

    # trisoup through the reference-exact brick, full size
    for tag, (flags, size, sha) in TRISOUP_EXACT_RUNS.items():
        recons = []
        with _spied(geometry_trisoup, "encode", recons):
            bin_path, rec, fields = _encode_and_decode_twice(
                tag, src, flags, [])
        got = np.round(host.ply.read(str(rec)).positions).astype(np.int64)
        if recons:       # the native-syntax brick: one slice, one call
            _check(len(recons) == 1 and got.shape[0] == len(recons[0][0]),
                   f"{tag}: decoded {got.shape[0]} points, the encoder "
                   f"reconstructed {[len(r) for r, _ in recons]}")
        if pinned:
            _check_pinned(tag, bin_path, size, sha)
            _check(got.shape[0] == TRISOUP_EXACT_POINTS,
                   f"{tag}: decoded {got.shape[0]} points, not "
                   f"{TRISOUP_EXACT_POINTS}")
        worst = _max_chebyshev(got, source, device, TRISOUP_MAX_DISTANCE)
        _line("l", run=tag, points=uniq.size, decoded_points=got.shape[0],
              max_distance_voxels=worst, limit=TRISOUP_MAX_DISTANCE,
              **fields)

    # trisoup's numpy surface model on a smaller cloud, the octree
    # front-end on the card and on the host engine
    small, small_colors = bench_cloud(n=v2_points, depth=v2_depth)
    small_src = CLI_DIR / "trisoup_v2.ply"
    _write_cloud(small_src, small, small_colors)
    analysed, runs = [], {}
    with _analysis_devices(analysed):
        for engine in ("device", "native"):
            analysed.clear()
            recons, surf_s = [], {}
            bin_path = CLI_DIR / f"trisoup_v2_{engine}.bin"
            with _spied(geometry_trisoup, "encode", recons), \
                    _timed(trisoup_ops, "reconstruct", surf_s), \
                    _timed(trisoup_ops, "determine_vertices", surf_s), \
                    _timed(trisoup_ops, "edge_coder_features", surf_s):
                _, enc_out = _cli(
                    ["--mode=0", f"--uncompressedDataPath={small_src}",
                     f"--compressedStreamPath={bin_path}",
                     f"--trisoupNodeSizeLog2={TRISOUP_LOG2}",
                     f"--geomEngine={engine}", "--attribute=color", *extra])
            _check(len(recons) == 1, f"{len(recons)} trisoup bricks")
            runs[engine] = SimpleNamespace(
                stream=bin_path.read_bytes(), recon=recons[0][0],
                analysed=list(analysed))
            _line("l", run=f"trisoup_v2_{engine}", points=small.size,
                  depth=v2_depth, encode_cli_wall_s=_cli_wall(enc_out),
                  geometry_s=f"{recons[0][1]:.3f}",
                  **{f"{k}_s": f"{v:.3f}" for k, v in surf_s.items()},
                  reconstructed_points=len(recons[0][0]),
                  stream_bytes=len(runs[engine].stream),
                  analysis_devices=",".join(analysed) or "none")
    dev, nat = runs["device"], runs["native"]
    _check(dev.stream == nat.stream,
           "the --geomEngine=device trisoup stream differs from the "
           "native one")
    _check(dev.analysed == [device.type] and not nat.analysed,
           f"the trisoup octree front-end analysed on {dev.analysed}, not "
           f"{device.type}")
    if pinned:
        _check(len(dev.stream) == TRISOUP_V2_BYTES,
               f"trisoup_v2: {len(dev.stream)} B, the JAX CLI writes "
               f"{TRISOUP_V2_BYTES} B")
    decoded = []
    rec = CLI_DIR / "trisoup_v2.ply.dec"
    with _spied(geometry_trisoup, "decode", decoded):
        _, dec_out = _cli(
            ["--mode=1",
             f"--compressedStreamPath={CLI_DIR / 'trisoup_v2_device.bin'}",
             f"--reconstructedDataPath={rec}", *extra])
    _check(len(decoded) == 1
           and np.array_equal(decoded[0][0], dev.recon)
           and np.array_equal(dev.recon, nat.recon),
           "the trisoup decode differs from the encoder's reconstruction")
    got = np.round(host.ply.read(str(rec)).positions).astype(np.int64)
    worst = _max_chebyshev(got, morton.decode(small), device,
                           TRISOUP_MAX_DISTANCE)
    _line("l", run="trisoup_v2", device_vs_native_stream="identical",
          decode="equals_encoder_reconstruction",
          decode_cli_wall_s=_cli_wall(dec_out),
          geometry_decode_s=f"{decoded[0][1]:.3f}",
          decoded_points=got.shape[0], max_distance_voxels=worst,
          limit=TRISOUP_MAX_DISTANCE,
          phase_s=f"{time.perf_counter() - t0:.1f}", card=repr(smi))


def _pair_law(v, w):
    """The fixed-point butterfly of (B, 8, C) int64 blocks by
    ``raht_fp``'s pair law (the host spec's ``ab_q15`` per merged pair,
    as tests/test_parallel.py:95-120 applies it), in numpy: (dc, acz, acy,
    acx)."""
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp
    half = 1 << (raht_fp.QA - 1)

    def stage(v, w):
        v0, v1 = v[:, 0::2], v[:, 1::2]
        w0, w1 = w[:, 0::2], w[:, 1::2]
        both = (w0 > 0) & (w1 > 0)
        a, b = raht_fp.ab_q15(np.where(both, w0, 1), np.where(both, w1, 1))
        a, b, both = a[..., None], b[..., None], both[..., None]
        dc = (a * v0 + b * v1 + half) >> raht_fp.QA
        ac = (a * v1 - b * v0 + half) >> raht_fp.QA
        out = np.where(both, dc, np.where((w0 > 0)[..., None], v0, v1))
        return out, np.where(both, ac, 0), w0 + w1

    vz, acz, wz = stage(v, w)
    vy, acy, wy = stage(vz, wz)
    vx, acx, _ = stage(vy, wy)
    return vx[:, 0], acz, acy, acx


def _mesh_blocks(fwd, n_slices, device, seed=MESH_VALUE_SEED):
    """(m4)/(m5)'s inputs: the blocks of every level of (d)'s float lane
    in one run, padded with empty blocks to ``n_slices`` equal slices:
    float values and weights (S, B, 8, C) / (S, B, 8), the weights as
    int64, and int64 Q13 values drawn from ``seed`` on occupied slots."""
    import torch
    bv = torch.cat([v for v, _ in fwd])
    bw = torch.cat([w for _, w in fwd])
    nb, _, nc = bv.shape
    pad = -nb % n_slices
    fv = torch.cat([bv, bv.new_zeros(pad, 8, nc)]).reshape(
        n_slices, -1, 8, nc)
    fw = torch.cat([bw, bw.new_zeros(pad, 8)]).reshape(n_slices, -1, 8)
    w = fw.to(torch.int64)
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randint(-(1 << 21), 1 << 21, fv.shape, generator=gen,
                      device=device, dtype=torch.int64)
    v = torch.where((w > 0)[..., None], q, 0)
    return nb, v, w, fv, fw


def _on_one(parts, device):
    """A sharded result's per-device parts, slice-major, on ``device``."""
    import torch
    return torch.cat([t.to(device) for t in parts])


def _shifted_reference(uniq, blocks, depth):
    """(m3)'s reference frame: the cloud moved one voxel along x and
    clipped to the cube, cut per slice to the codes within the slice's
    range and padded with INT64_MAX: (refs (S, M), counts (S,) int32)."""
    from mpeg_pcc_tmc13_tpu_torch.utils import morton
    pos = morton.decode(uniq)
    pos[:, 0] = np.minimum(pos[:, 0] + 1, (1 << depth) - 1)
    ref = np.unique(morton.encode(pos))
    rows = [ref[(ref >= b.min()) & (ref <= b.max())] for b in blocks]
    refs = np.full((len(rows), max(r.size for r in rows)),
                   np.iinfo(np.int64).max, dtype=np.int64)
    for s, r in enumerate(rows):
        refs[s, :r.size] = r
    return refs, np.array([r.size for r in rows], dtype=np.int32)


def phase_m(device, uniq, depth, colors, smi, n_slices=MESH_SLICES,
            backend=None):
    """(m) the multi-device layer ``parallel/`` on a mesh of every visible
    card (``backend="cpu"``: a rehearsal on two host entries), the bench
    cloud split into ``n_slices`` slices.  The launch counts are set to 0
    before (m1) and read after (m7); every check uses the plain versions
    or the host, so only the path launches the kernels.  Then
    ``raht_fwd_blocks_int`` is timed at (m4)'s shapes.  Returns (times,
    launches, max abs differences) of the kernels it adds."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch import host
    from mpeg_pcc_tmc13_tpu_torch.models import geometry_octree as go
    from mpeg_pcc_tmc13_tpu_torch.models.attr_raht import qp_to_step_q16
    from mpeg_pcc_tmc13_tpu_torch.models.attributes import \
        AttributeContexts
    from mpeg_pcc_tmc13_tpu_torch.ops import octree
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_blocks as rb
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
    from mpeg_pcc_tmc13_tpu_torch.parallel import frame as pframe
    from mpeg_pcc_tmc13_tpu_torch.parallel import slices as par
    from mpeg_pcc_tmc13_tpu_torch.parallel.dryrun import dryrun_multichip
    from mpeg_pcc_tmc13_tpu_torch.utils import morton

    t_phase = time.perf_counter()
    ndev = torch.cuda.device_count() if backend is None else 2
    mesh = par.make_mesh(ndev, backend=backend)
    blocks = par.partition_codes_padded(uniq, n_slices)
    per_dev = n_slices // ndev
    _reset_launches()

    # (m1) sharded analysis: each slice equals the single-slice analysis,
    # the histogram the host sum of the masked bases
    t0 = time.perf_counter()
    res, hist = par.sharded_encode_analysis(blocks, depth, mesh)
    for s in range(n_slices):
        part = {k: v[s // per_dev][s % per_dev] for k, v in res.items()}
        one = octree.encode_analysis(torch.as_tensor(
            blocks[s], device=part["occ"].device), depth)
        _check(all(torch.equal(part[k], one[k]) for k in one),
               f"(m1) slice {s}: the sharded analysis differs from "
               "encode_analysis")
    base, mask = (par.gather(res[k]) for k in ("ctx_base", "node_mask"))
    want = np.bincount(base[mask], minlength=octree.NUM_OCC_BASES)
    _check(hist.device == mesh.devices[0]
           and np.array_equal(hist.cpu().numpy(), want),
           "(m1) the histogram differs from the host sum")
    _line("m", stage="m1_sharded_encode_analysis", slices=n_slices,
          devices=ndev, points=uniq.size, padded_row=blocks.shape[1],
          depth=depth, nodes=int(mask.sum()), per_slice="identical",
          histogram="equals_host_sum", s=f"{time.perf_counter() - t0:.2f}")

    # (m2) the sharded codec round trip checks itself: each slice's
    # bytes equal the host engine's, the decode gives the cloud back
    t0 = time.perf_counter()
    payloads = par.sharded_slice_codec_roundtrip(uniq, depth, mesh,
                                                 n_slices)
    _line("m", stage="m2_sharded_slice_codec_roundtrip",
          bytes=sum(len(p) for p in payloads), vs_host_engine="identical",
          roundtrip="exact", s=f"{time.perf_counter() - t0:.2f}")

    # (m3) inter analysis against the cloud moved one voxel along x:
    # each level equals build_levels_np and pred_occupancy_np
    t0 = time.perf_counter()
    refs, counts = _shifted_reference(uniq, blocks, depth)
    got = par.gather(par.sharded_encode_analysis_inter(
        blocks, depth, refs, counts, mesh))
    for s in range(n_slices):
        rs = refs[s, :counts[s]]
        levels = octree.build_levels_np(np.unique(blocks[s]), depth,
                                        octree.CTX_MODE_PARENT)
        for l, lvl in enumerate(levels):
            pred = octree.pred_occupancy_np(
                lvl["nodes"], np.unique(rs >> (3 * (depth - l - 1))))
            m = got["node_mask"][s, l]
            _check(np.array_equal(got["occ"][s, l][m], lvl["occ"])
                   and np.array_equal(
                       got["ctx_base"][s, l][m],
                       ((lvl["nodes"] & 7).astype(np.int32) << 8) | pred),
                   f"(m3) slice {s} level {l} differs from "
                   "pred_occupancy_np")
    _line("m", stage="m3_sharded_encode_analysis_inter",
          reference="shifted_1_voxel_x", ref_codes=int(counts.sum()),
          levels_vs_pred_occupancy_np="identical",
          s=f"{time.perf_counter() - t0:.2f}")

    # (m4) the fixed-point block stage on the mesh over every level of
    # (d)'s float lane: the kernel equals its plain version, a sample of
    # blocks the host spec's pair law
    t0 = time.perf_counter()
    fwd, _ = _level_inputs(uniq, colors, depth, device)
    nb, v8, w8, fv8, fw8 = _mesh_blocks(fwd, n_slices, device)
    nc = v8.shape[-1]
    vf, wf = v8.reshape(-1, 8, nc), w8.reshape(-1, 8)
    fp_out = [_on_one(p, device) for p in par.sharded_raht_fp_blocks(
        v8, w8, mesh)]
    fp_ref = fpd.fwd_blocks_int_ref(vf, wf)
    _sync(device)
    fp_out = [o.reshape(r.shape) for o, r in zip(fp_out, fp_ref)]
    fp_err = _max_abs_diff(zip(fp_out, fp_ref))
    _check(all(torch.equal(o, r) for o, r in zip(fp_out, fp_ref)),
           f"(m4) raht_fwd_blocks_int differs from fwd_blocks_int_ref: "
           f"max abs {fp_err}")
    pick = np.random.default_rng(MESH_VALUE_SEED).choice(
        vf.shape[0], PAIR_LAW_SAMPLE, replace=False)
    idx = torch.as_tensor(pick, device=device)
    law = _pair_law(vf[idx].cpu().numpy(), wf[idx].cpu().numpy())
    _check(all(np.array_equal(o[idx].cpu().numpy(), x)
               for o, x in zip(fp_out, law)),
           "(m4) sampled blocks differ from raht_fp's pair law")
    _line("m", stage="m4_sharded_raht_fp_blocks", levels=len(fwd),
          blocks=nb, padded_to=vf.shape[0], channels=nc,
          vs_fwd_blocks_int_ref="identical", max_abs_err=fp_err, tol=0,
          pair_law_sample=PAIR_LAW_SAMPLE,
          s=f"{time.perf_counter() - t0:.2f}")

    # (m5) B1 on every device of the mesh equals its plain version
    t0 = time.perf_counter()
    f_out = [_on_one(p, device)
             for p in par.sharded_raht_blocks(fv8, fw8, mesh)]
    f_ref = rb.fwd_blocks_ref(fv8.reshape(-1, 8, nc), fw8.reshape(-1, 8))
    _sync(device)
    f_out = [o.reshape(r.shape) for o, r in zip(f_out, f_ref)]
    f_err = _max_abs_diff(zip(f_out, f_ref))
    _check(all(torch.equal(o, r) for o, r in zip(f_out, f_ref)),
           f"(m5) sharded B1 differs from fwd_blocks_ref: max abs {f_err}")
    _line("m", stage="m5_sharded_raht_blocks", blocks=vf.shape[0],
          vs_fwd_blocks_ref="identical", max_abs_err=f_err, tol=0,
          s=f"{time.perf_counter() - t0:.2f}")

    # (m6) the frame codec placed slice by slice, (d)'s colours at qp 22:
    # geometry equals the host engine's PARENT stream, colour the
    # fixed-point spec's, and the decode gives the codes back
    t0 = time.perf_counter()
    devs = pframe.devices_for(ndev, backend=backend)
    per = blocks.shape[1]
    slice_codes = [np.unique(b) for b in blocks]
    slice_vals = [colors[s * per:s * per + c.size]
                  for s, c in enumerate(slice_codes)]
    step = qp_to_step_q16(BENCH_QP)
    geom_p, attr_p = pframe.encode_frame_sharded(
        slice_codes, depth, devs, values=slice_vals, steps_q16=[step] * 3,
        num_threads=4)
    enc_s = time.perf_counter() - t0
    nmax = max(c.size for c in slice_codes) + 64
    outs = pframe.decode_frame_sharded(geom_p, depth, devs, nmax)
    for s, (nodes, cnt) in enumerate(outs):
        _check(nodes.device == devs[s % ndev]
               and np.array_equal(nodes[:int(cnt)].cpu().numpy(),
                                  slice_codes[s]),
               f"(m6) slice {s} decodes to other codes")
    codec_s = time.perf_counter() - t0
    for s, codes in enumerate(slice_codes):
        enc = host.RangeEncoder()
        go.encode(morton.decode(codes), depth, enc, go.OctreeContexts(),
                  unique_points=True, engine="native", need_order=False,
                  ctx_mode=octree.CTX_MODE_PARENT)
        aenc = host.RangeEncoder()
        actx = AttributeContexts()
        host.forward_predicted_fp(
            codes, slice_vals[s], depth, lambda c, tag: step,
            emit=lambda q, tag: aenc.zrow_residuals(actx.zrow,
                                                    q.astype(np.int32)))
        _check(geom_p[s] == enc.get_bytes(),
               f"(m6) slice {s}: geometry differs from the host engine's")
        _check(attr_p[s] == aenc.get_bytes(),
               f"(m6) slice {s}: colour differs from forward_predicted_fp")
    _line("m", stage="m6_encode_decode_frame_sharded", slices=n_slices,
          geom_bytes=sum(map(len, geom_p)), attr_bytes=sum(map(len, attr_p)),
          geom_vs_host_engine="identical", attr_vs_spec="identical",
          spec_slices=n_slices, decoded_codes="identical",
          encode_s=f"{enc_s:.2f}", encode_decode_s=f"{codec_s:.2f}",
          s=f"{time.perf_counter() - t0:.2f}")

    # (m7) the dry run of every stage on the mesh's devices
    t0 = time.perf_counter()
    dryrun_multichip(ndev, backend=backend)
    launches = _launches("fwd_blocks_int", "fwd_blocks")
    _line("m", stage="m7_dryrun_multichip", devices=ndev,
          s=f"{time.perf_counter() - t0:.2f}")
    _line("m", launches=json.dumps(launches, separators=(",", ":")),
          phase_s=f"{time.perf_counter() - t_phase:.1f}", card=repr(smi))
    _check(all(launches.values()),
           f"(m) a kernel of the path was not launched: {launches}")

    # the redesigned kernel beyond the path's shapes: ragged tiles, the
    # persistent grid's tail, channel runs, general-path blocks
    fp_err = max(fp_err, _fp_shape_checks(device))

    # raht_fwd_blocks_int at (m4)'s shapes, colour and reflectance: one
    # launch over every local block, as the sharded call makes on one card
    times = {}
    for nch in (nc, 1):
        v = vf if nch == nc else vf[..., :nch].contiguous()
        k, p, d = _turns("fwd_blocks_int", lambda: fpd.fwd_blocks_int(v, wf),
                         lambda: fpd.fwd_blocks_int_ref(v, wf), tag="m",
                         blocks=v.shape[0], channels=nch)
        nbytes = _io_bytes(v, wf, *fpd.fwd_blocks_int_ref(v, wf))
        issue, per_block, mhz = _fp_issue_bound(
            nch, v.shape[0], lambda: fpd.fwd_blocks_int(v, wf))
        byte_ms = _bound_ms(nbytes)[0]
        bound, by = max((byte_ms, "bytes"), (issue, "operations"))
        _line("m", kernel="fwd_blocks_int", channels=nch, device_ms=f"{d:.4f}",
              bound_ms=f"{bound:.4f}", bound_by=by, share=f"{bound / d:.3f}",
              byte_bound_ms=f"{byte_ms:.4f}", bytes=nbytes,
              bytes_per_block=f"{nbytes / v.shape[0]:.1f}",
              issue_bound_ms=f"{issue:.4f}",
              fast_path_sass_per_block=per_block, sm_clock_mhz=mhz)
        if nch == nc:
            times["fwd_blocks_int"] = (k, p, d, bound, by)
    return (times, {"fwd_blocks_int": launches["fwd_blocks_int"]},
            {"fwd_blocks_int": fp_err})


FP_CHECK_BLOCKS = (1, 127, 128, 129, 300_001)  # tiles of 128, grid tail
FP_CHECK_CHANNELS = (1, 2, 3, 5, 28, 32)        # 5, 28, 32 in runs of 4


def _fp_check_inputs(nb, nc, seed, device):
    """(B, 8, C) int64 values and (B, 8) weights for the kernel's checks:
    occupancy patterns with weights 1..64 (the fast path), and in every
    tile a few blocks with weights up to 2^29 a slot (sums of 2^22-2^32:
    the general path), block 0 one weight of 2^32 - 1; Q13 values, and
    values over the whole int64 range in every 7th block (the mix
    wraps)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    occ = torch.randint(0, 2, (nb, 8), generator=g, device=device).bool()
    w = torch.where(occ, torch.randint(1, 65, (nb, 8), generator=g,
                                       device=device), 0)
    big = torch.arange(min(5, nb - 1), nb, 61, device=device)
    w[big] = torch.randint(0, 1 << 29, (big.numel(), 8), generator=g,
                           device=device)
    w[0, 0] = (1 << 32) - 1
    v = torch.randint(-(1 << 21), 1 << 21, (nb, 8, nc), generator=g,
                      device=device)
    wide = torch.arange(0, nb, 7, device=device)
    v[wide] = torch.randint(-(1 << 62), 1 << 62, (wide.numel(), 8, nc),
                            generator=g, device=device) * 2
    return v, w


def _fp_shape_checks(device):
    """``raht_fwd_blocks_int`` against ``fwd_blocks_int_ref`` at every B of
    ``FP_CHECK_BLOCKS`` and C of ``FP_CHECK_CHANNELS``, bit for bit, each
    call one launch per run of ``channel_runs(C)``.  Returns the largest
    absolute difference (0)."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
    t0 = time.perf_counter()
    err, general, launched = 0, 0, {}
    for nb in FP_CHECK_BLOCKS:
        for nch in FP_CHECK_CHANNELS:
            v, w = _fp_check_inputs(nb, nch, nb * 64 + nch, device)
            before = _launches("fwd_blocks_int")["fwd_blocks_int"]
            got = fpd.fwd_blocks_int(v, w)
            launched[nch] = _launches("fwd_blocks_int")["fwd_blocks_int"] \
                - before
            want = fpd.fwd_blocks_int_ref(v, w)
            _sync(device)
            e = _max_abs_diff(zip(got, want))
            err = max(err, e)
            _check(all(torch.equal(a, b) for a, b in zip(got, want)),
                   f"(m) raht_fwd_blocks_int differs from fwd_blocks_int_ref "
                   f"at B={nb}, C={nch}: max abs {e}")
            _check(launched[nch] == len(fpd.channel_runs(nch)),
                   f"(m) B={nb}, C={nch}: {launched[nch]} launches, want "
                   f"{len(fpd.channel_runs(nch))}")
            general += int((~fpd.fast_blocks(w)).sum())
    _line("m", stage="fwd_blocks_int_shapes", blocks=list(FP_CHECK_BLOCKS),
          channels=list(FP_CHECK_CHANNELS),
          launches_per_call=json.dumps(launched, separators=(",", ":")),
          general_path_blocks=general, vs_fwd_blocks_int_ref="identical",
          max_abs_err=err, tol=0, s=f"{time.perf_counter() - t0:.2f}")
    return err


def _fp_issue_bound(nc, nblocks, run, launches=1500):
    """The issue bound of ``raht_fwd_blocks_int`` at ``nc`` channels: the
    SASS instructions of its fast path a block (``cuobjdump -sass`` on the
    built library: ``raht_fp_fast_block_count_c<nc>``, one block a thread
    through the fast path, loads and stores included, every instruction
    but NOPs once), one warp instruction serving 32 blocks, over the
    card's 4 schedulers an SM issuing one warp instruction a cycle each at
    the SM clock nvidia-smi reads while ``run`` keeps the card busy.
    Returns (ms, instructions a block, MHz)."""
    import torch
    per_block = _sass_instructions(f"raht_fp_fast_block_count_c{nc}")
    mhz = _sm_mhz_under(run, launches)   # ~0.5 s of work for the clock
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warps = -(-nblocks // 32)
    return per_block * warps / (sms * 4 * mhz * 1e6) * 1e3, per_block, mhz


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


def _turns(name, kern, ref, reps_plain=TIMING_REPS, tag="f", **shape):
    """Plain, kernel, kernel, plain, then the kernel's pass as a replayed
    CUDA graph twice; returns (kernel ms, plain ms, device ms)."""
    p1 = _time_pass_ms(ref, reps_plain)
    k1 = _time_pass_ms(kern)
    k2 = _time_pass_ms(kern)
    p2 = _time_pass_ms(ref, reps_plain)
    d1 = _graph_ms(kern)
    d2 = _graph_ms(kern)
    _line(tag, kernel=name, **shape, kernel_ms=f"{k1:.4f},{k2:.4f}",
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


def _sass_instructions(name):
    """SASS instructions of kernel ``name`` in the built library
    (``cuobjdump -sass``), every instruction but NOPs once."""
    from mpeg_pcc_tmc13_tpu_torch.ops import _kernels
    nvcc = _kernels._find_nvcc()
    _check(nvcc is not None, "no CUDA toolkit for cuobjdump")
    sass = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
         str(_kernels.library_path())], capture_output=True, text=True,
        check=True).stdout
    m = re.search(rf"Function : {re.escape(name)}\s", sass)
    _check(m is not None, f"cuobjdump shows no {name}")
    at = m.start()
    end = sass.find("Function : ", at + 1)
    body = sass[at:end if end > 0 else None]
    return sum(1 for op in re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*);", body)
               if not op.strip().startswith("NOP"))


def _sm_mhz_under(run, launches):
    """The SM clock nvidia-smi reads after ``launches`` calls of ``run``
    keep the card busy."""
    import torch
    for _ in range(launches):
        run()
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-i", str(torch.cuda.current_device())],
        capture_output=True, text=True, check=True).stdout.split()[0])
    torch.cuda.synchronize()
    return mhz


def _group_sass_issue(rec, run):
    """The issue time of ``DeviceFpRaht``'s 22 groups as this code is
    compiled (a diagnostic of the implementation, not a bound of the
    function: it counts the instructions the kernel issues, not the
    work the function needs): per tile of 32
    parent blocks one warp runs the block prologue and W = min(C, 4)
    warps a (block, channel) each (the SASS instructions of
    ``raht_fp_group_prologue_count`` and of ``raht_fp_group_block_count_
    enc``/``_dec``, every branch once: with ~10 blocks a warp each child
    and pair slot is present in some lane), one warp instruction a cycle
    on each of the 4 schedulers of every SM at the SM clock under load.
    The staging and the gather are left out.  Returns (ms, prologue,
    encode and decode instructions, MHz)."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
    pro = _sass_instructions("raht_fp_group_prologue_count")
    blk = {s: _sass_instructions(f"raht_fp_group_block_count_{s}")
           for s in ("enc", "dec")}
    nc = rec.vals.shape[1]
    w = min(nc, fpd.GROUP_WINDOW)
    warp_instr = 0
    for steps, side in ((rec.enc, "enc"), (rec.dec, "dec")):
        for a, _ in steps:
            tiles = -(-a[6]["az"].shape[0] // fpd.GROUP_TILE)
            warp_instr += tiles * (pro + w * blk[side] * -(-nc // w))
    mhz = _sm_mhz_under(run, 200)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (warp_instr / (sms * 4 * mhz * 1e6) * 1e3, pro, blk["enc"],
            blk["dec"], mhz)


def _expand_bytes(stream):
    """What the expansion of ``stream`` must move: each level's bytes and
    (below the root) its parents' codes read, the intermediate levels'
    children's codes written and read back, the final level's nmax codes
    (padding included) written, the counts read."""
    occ, counts, depth, nmax = stream
    rows = [min(int(c), nmax) for c in counts.tolist()]
    pops = np.unpackbits(occ.cpu().numpy()[:, None], axis=1).sum(axis=1)
    off, tot = 0, []
    for r, c in zip(rows, counts.tolist()):
        tot.append(int(pops[off:off + r].sum()))
        off += int(c)
    return (sum(rows) + 8 * sum(rows[1:])
            + 8 * sum(min(t, nmax) for t in tot[:-1]) + 8 * nmax
            + 4 * depth)


def _headline_times(rec):
    """The headline path's four kernels against their plain versions at
    (p)'s shapes, in turns, each pass as the main path runs it: the
    occupancy pass of the bench cloud, the expansion of its stream (a
    counting launch and one a level), ``DeviceFpRaht``'s 11
    truth levels, and its 11 encode then 11 decode groups (the means
    handed on); the plain pass is the 11 or 22 ``_ref`` calls of the same
    steps.  Each with the bytes it must move (each step's inputs read once
    and its outputs written once: the plan tensors the kernel reads; the
    expansion's intermediate levels counted, the groups' hand-on not).
    Then, for the two kernels redesigned last: one link of the
    expansion's chain alone (its chain bound: the 12 links of a stream)
    and its largest level alone; the largest group alone (the finest
    encode group, means handed on) and the groups' SASS issue time (a
    diagnostic; their bound stays the byte bound).  Returns (times,
    chain bounds)."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import octree
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_plan as rp
    from mpeg_pcc_tmc13_tpu_torch.scripts.kernel_turns import \
        largest_encode_group

    def plan(p):                        # the 22 plan tensors a group reads
        return rp.kernel_plan(p, rp.row_offsets(p))
    nbf = len(rp.BUTTERFLY_KEYS) + 3   # the 16 the truth level reads
    times, chains = {}, {}
    depth = rec.stream[2]
    occ_args = (rec.codes, depth, rec.cap)
    truth = rec.dv._truth_kernels(rec.vals, fpd.CUDA_LAUNCHERS)
    group_pass = (
        lambda: (rec.dv._enc_group_kernels(*truth, fpd.CUDA_LAUNCHERS),
                 rec.dv._decode_kernels(rec.rows, fpd.CUDA_LAUNCHERS)))
    cases = {
        "octree_occ_u8": (
            lambda: octree.encode_occ_u8_hdr(*occ_args),
            lambda: octree.encode_occ_u8_hdr_ref(*occ_args),
            _io_bytes(rec.codes, octree.encode_occ_u8_hdr_ref(*occ_args)),
            dict(points=rec.codes.numel(), depth=depth)),
        "octree_expand": (
            lambda: octree.decode_expand_stream(*rec.stream),
            lambda: octree.decode_expand_stream_ref(*rec.stream),
            _expand_bytes(rec.stream),
            dict(levels=depth, nmax=rec.stream[3])),
        "raht_fp_truth_level": (
            lambda: rec.dv._truth_kernels(rec.vals, fpd.CUDA_LAUNCHERS),
            lambda: [fpd._truth_level_ref(*a) for a, _ in rec.truth],
            sum(_io_bytes(a[0], *plan(a[1])[:nbf], *fpd._truth_level_ref(*a))
                for a, _ in rec.truth),
            dict(levels=len(rec.truth))),
        "raht_fp_group": (
            group_pass,
            lambda: ([fpd._enc_group_ref(*a, **kw) for a, kw in rec.enc],
                     [fpd._dec_group_ref(*a, **kw) for a, kw in rec.dec]),
            sum(_io_bytes(*a[:6], *plan(a[6]), *ref(*a, **kw))
                for steps, ref in ((rec.enc, fpd._enc_group_ref),
                                   (rec.dec, fpd._dec_group_ref))
                for a, kw in steps),
            dict(groups=f"{len(rec.enc)}+{len(rec.dec)}")),
    }
    for name, (kern, ref, nbytes, shape) in cases.items():
        k, p, d = _turns(name, kern, ref, **shape)
        bound, by = _bound_ms(nbytes)
        times[name] = (k, p, d, bound, by)
        _line("f", kernel=name, pass_ms=f"{k:.4f}", device_ms=f"{d:.4f}",
              bound_ms=f"{bound:.4f}", bound_by=by,
              share=f"{bound / d:.4f}", bytes=nbytes)

    # the expansion: one link of its chain alone, the largest level
    n = rec.stream[3]
    links = depth + 1                   # a counting launch, one a level
    link_ms = _graph_ms(lambda: [octree.expand_chain_probe(
        n, rec.codes.device) for _ in range(links)]) / links
    chains["octree_expand"] = links * link_ms
    big = rec.expand_levels[-1]
    big_ms = _graph_ms(lambda: octree._expand_level(*big))
    big_bound, _ = _bound_ms(_io_bytes(*big[:2], *octree._expand_level_ref(
        *big, *rec.expand_tabs)))
    k, p, d, bound, by = times["octree_expand"]
    _line("f", kernel="octree_expand", link_ms=f"{link_ms:.5f}",
          chain_bound_ms=f"{links * link_ms:.4f}",
          byte_bound_ms=f"{bound:.4f}",
          share=f"{max(bound, links * link_ms) / d:.4f}",
          largest_level_rows=n, largest_level_ms=f"{big_ms:.4f}",
          largest_level_bound_ms=f"{big_bound:.4f}",
          largest_level_share=f"{big_bound / big_ms:.4f}")

    # the groups: the largest alone, and the issue time of the 22 as
    # compiled (a diagnostic: the bound stays the byte bound)
    a, kw = largest_encode_group(rec.dv, truth)
    big_ms = _graph_ms(lambda: fpd._cuda_group(*a, **kw))
    ea, ekw = rec.enc[-1]
    big_bound, _ = _bound_ms(_io_bytes(*ea[:6], *plan(ea[6]),
                                       *fpd._enc_group_ref(*ea, **ekw)))
    issue, pro, blk_enc, blk_dec, mhz = _group_sass_issue(rec, group_pass)
    k, p, d, bound, by = times["raht_fp_group"]
    _line("f", kernel="raht_fp_group", byte_bound_ms=f"{bound:.4f}",
          share=f"{bound / d:.4f}", sass_issue_ms=f"{issue:.4f}",
          sass_prologue=pro, sass_block_enc=blk_enc,
          sass_block_dec=blk_dec, sm_mhz=mhz,
          largest_group_blocks=int(a[2]), largest_group_ms=f"{big_ms:.4f}",
          largest_group_bound_ms=f"{big_bound:.4f}",
          largest_group_share=f"{big_bound / big_ms:.4f}")
    return times, chains


def phase_f(device, uniq, depth, colors, rans, errs, headline):
    """Stage times of a warm round trip and of a warm rANS round trip,
    B1/B2 checked at every level of (d), and each kernel timed against
    its plain version at the shapes of (d), (g) and (p), in turns plain,
    kernel, kernel, plain."""
    from mpeg_pcc_tmc13_tpu_torch.models import geometry_rans as gr
    from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt
    from mpeg_pcc_tmc13_tpu_torch.utils import morton

    r = rt.device_roundtrip(uniq, depth, colors, qp=BENCH_QP, device=device)
    _line("f", warm_stage_s=json.dumps(
        {k: round(v, 6) for k, v in r.stage_s.items()},
        separators=(",", ":")),
        host_entropy_s=r.geom_stats.host_entropy_s,
        link_bytes=r.geom_stats.link_bytes)
    pos = morton.decode(uniq)
    enc_s, dec_s = [rans.encode_s], [rans.decode_s]
    for _ in range(WARM_RANS_REPS):
        _sync(device)
        t0 = time.perf_counter()
        payload = gr.encode(pos, depth, device=device)
        t1 = time.perf_counter()
        gr.decode(payload, uniq.size, depth, device=device)
        t2 = time.perf_counter()
        _check(payload == rans.payload,
               "warm rANS payload differs from (g)'s")
        enc_s.append(t1 - t0)
        dec_s.append(t2 - t1)
    _line("f", rans_encode_s=",".join(f"{v:.4f}" for v in enc_s),
          rans_decode_s=",".join(f"{v:.4f}" for v in dec_s),
          note=f"first,then_{WARM_RANS_REPS}_warm")

    _profile_rans(device, pos, depth, uniq.size, rans.payload)
    times = _block_times(device, uniq, depth, colors, errs)
    rans_times, chain_ms = _rans_times(rans)
    times.update(rans_times)
    head_times, head_chains = _headline_times(headline)
    times.update(head_times)
    times["raht_fp_plan"] = _plan_times(headline.codes, uniq, depth)
    chain_ms.update(head_chains)
    return times, chain_ms


def _profiled_ms(prof, names, reps=1):
    """{name: device ms a pass} of the kernels whose entry names contain
    each of ``names``, from a ``torch.profiler`` trace of ``reps``
    passes."""
    dev = dict.fromkeys(names, 0.0)
    for ev in prof.key_averages():
        for name in names:
            if name in ev.key:
                us = getattr(ev, "device_time_total", None)
                if us is None:
                    us = ev.cuda_time_total
                dev[name] += us / 1e3 / reps
    return dev


def _plan_times(codes, uniq, depth, reps=TIMING_REPS):
    """The RAHT planner as ``DeviceFpRaht`` runs it on the bench cloud
    (``build_plan``: three launches and one host read of the counts)
    against its plain version, in turns plain, kernel, kernel, plain,
    CUDA events around whole passes (the pass waits for its counts, so
    it cannot be captured as a graph); its device time, the three
    kernels' under ``torch.profiler``; its bound, the codes read and
    every plan tensor written once; and, beside it, the host planner it
    replaced (``build_fp_plan``, then the upload: ``plans_to_torch`` and
    ``row_offsets``) by the host clock.  Returns (pass ms, plain ms,
    device ms, bound ms, what bounds it)."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_plan as rp

    def kern():
        return rp.build_plan(codes, depth)

    def ref():
        return rp.build_plan_ref(codes, depth)
    p1 = _time_pass_ms(ref, PLAN_PLAIN_REPS)
    k1 = _time_pass_ms(kern, reps)
    k2 = _time_pass_ms(kern, reps)
    p2 = _time_pass_ms(ref, PLAN_PLAIN_REPS)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            kern()
        torch.cuda.synchronize()
    dev = _profiled_ms(prof, PLAN_KERNELS, reps)
    d = sum(dev.values())
    _check(all(v > 0 for v in dev.values()),
           f"torch.profiler timed not every planner kernel: {dev}")
    plan = kern()
    nbytes = _io_bytes(codes, *(t for p, offs in zip(plan.plans,
                                                     plan.offsets)
                                for t in list(p.values()) + list(offs)))
    bound, by = _bound_ms(nbytes)
    t0 = time.perf_counter()
    host = fpd.build_fp_plan(uniq, depth)
    t1 = time.perf_counter()
    [rp.row_offsets(q) for q in fpd.plans_to_torch(host, codes.device)]
    _sync(codes.device)
    t2 = time.perf_counter()
    _line("f", kernel="raht_fp_plan", levels=depth, points=codes.numel(),
          kernel_ms=f"{k1:.4f},{k2:.4f}", plain_ms=f"{p1:.4f},{p2:.4f}",
          device_ms=f"{d:.4f}",
          kernels_ms=",".join(f"{v:.4f}" for v in dev.values()),
          bound_ms=f"{bound:.4f}", bound_by=by, share=f"{bound / d:.4f}",
          bytes=nbytes, host_plan_ms=f"{(t1 - t0) * 1e3:.1f}",
          host_upload_ms=f"{(t2 - t1) * 1e3:.1f}")
    return min(k1, k2), min(p1, p2), d, bound, by


# host-side calls that wait for the device, as the profiler names them:
# ``counts.tolist()`` and ``.cpu()`` are a copy (aten::_to_copy over
# cudaMemcpyAsync and cudaStreamSynchronize), ``wdense[flags]`` an
# aten::index that sizes its result with aten::nonzero, ``int(tensor)``
# an aten::item over aten::_local_scalar_dense
@contextlib.contextmanager
def _repo_on_path():
    """Put the repository on PYTHONPATH for the processes started inside
    (the scripts start the CLI as ``python -m``)."""
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), old) if p)
    try:
        yield
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old


def _cli_in_process(cmd, capture_output=True, text=True):
    """``subprocess.run`` of ``python -m <the port's CLI> args``, run by
    ``runtime.cli.main`` in this process."""
    from mpeg_pcc_tmc13_tpu_torch.runtime import cli
    _check(cmd[1:3] == ["-m", "mpeg_pcc_tmc13_tpu_torch.runtime.cli"],
           f"not the port's CLI: {cmd[:3]}")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(list(cmd[3:]))
    return subprocess.CompletedProcess(cmd, rc, out.getvalue(),
                                       err.getvalue())


def _host_geom_bytes(codes, n_slices, depth):
    """Payload bytes of the host engine (native, PARENT contexts) over
    ``partition_codes_padded``'s slices of ``codes``."""
    from mpeg_pcc_tmc13_tpu_torch import host
    from mpeg_pcc_tmc13_tpu_torch.models import geometry_octree as go
    from mpeg_pcc_tmc13_tpu_torch.ops import octree
    from mpeg_pcc_tmc13_tpu_torch.parallel import slices as par
    from mpeg_pcc_tmc13_tpu_torch.utils import morton
    total = 0
    for row in par.partition_codes_padded(codes, n_slices):
        enc = host.RangeEncoder()
        go.encode(morton.decode(np.unique(row)), depth, enc,
                  go.OctreeContexts(), unique_points=True, engine="native",
                  need_order=False, ctx_mode=octree.CTX_MODE_PARENT)
        total += len(enc.get_bytes())
    return total


def phase_n(device, smi):
    """The evaluation layer, as a user runs it, every failure fatal:
    (n1) the CTC-style inputs, (n2) the conformance matrix (its CLI runs
    in this process, one decode in a process of its own), (n3) the parity
    harness (codec ``ours``, each CLI run a process) at r04,
    (n4) the mesh-scaling check on every visible card."""
    import shutil

    from mpeg_pcc_tmc13_tpu_torch import host
    from mpeg_pcc_tmc13_tpu_torch.scripts import ctc_matrix, gen_clouds
    from mpeg_pcc_tmc13_tpu_torch.scripts import mesh_scaling, parity
    from mpeg_pcc_tmc13_tpu_torch.utils import morton

    t_phase = time.perf_counter()
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    EVAL_DIR.mkdir(parents=True)

    # (n1) the surface and one LiDAR frame, byte for byte the reference
    # generator's
    DATA_DIR.mkdir(exist_ok=True)
    for name, (kind, sha) in GEN_CLOUDS.items():
        path = DATA_DIR / name
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            gen_clouds.main([*kind, str(DATA_DIR / name.replace(
                "0000", "%04d"))])
        secs = time.perf_counter() - t0
        _check(_sha256(path) == sha,
               f"(n1) {name}: sha256 {_sha256(path)}; the reference "
               f"generator writes {sha}")
        _line("n", stage="n1_gen_clouds", file=f"data/{name}",
              written=out.getvalue().split(": ", 1)[1].strip().replace(
                  " ", "_"),
              bytes=path.stat().st_size, sha256="as_reference",
              s=f"{secs:.2f}")

    # (n2) the conformance matrix on its default seeded cloud.  Its
    # 28 CLI runs go through ``runtime.cli.main`` in this process (a
    # process start took ~8 s on an H100 machine's host), and one
    # family's stream is decoded again by the command a user runs
    work = EVAL_DIR / "ctc_matrix"
    work.mkdir()
    src = work / "in.ply"
    ctc_matrix.synth_cloud(str(src))
    real = ctc_matrix.subprocess
    ctc_matrix.subprocess = SimpleNamespace(run=_cli_in_process)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = ctc_matrix.main([str(src), str(work)])
    finally:
        ctc_matrix.subprocess = real
    secs = time.perf_counter() - t0
    summary = json.loads(out.getvalue())
    _check(rc == 0, f"(n2) ctc_matrix returned {rc}: {summary}")
    sub = work / f"{CTC_SUBPROCESS_FAMILY}_subprocess.ply"
    sub_s, _ = _cli_process(
        ["--mode=1", f"--compressedStreamPath="
         f"{work / (CTC_SUBPROCESS_FAMILY + '.bin')}",
         f"--reconstructedDataPath={sub}"])
    _check(ctc_matrix.md5(str(sub))
           == CTC_MATRIX_MD5[CTC_SUBPROCESS_FAMILY][1],
           f"(n2) the CLI process decoded {CTC_SUBPROCESS_FAMILY} to "
           f"another PLY")
    _check(summary["ok"], f"(n2) ctc_matrix: not ok: {summary}")
    got = {k: (v.get("stream_md5"), v.get("decoded_md5"))
           for k, v in summary["configs"].items()}
    _check(got == CTC_MATRIX_MD5,
           f"(n2) md5s differ from the JAX script's: "
           f"{ {k: v for k, v in got.items() if CTC_MATRIX_MD5.get(k) != v} }")
    cfgs = summary["configs"]
    _line("n", stage="n2_ctc_matrix", families=len(cfgs),
          points=host.ply.read(str(src)).count,
          md5s=f"as_reference_x{len(cfgs)}",
          lossless=sum(v["geom_lossless"] for v in cfgs.values()),
          bytes=sum(v["bytes"] for v in cfgs.values()),
          cli_user_s=json.dumps(
              {k: [v["encode_s"], v["decode_s"]] for k, v in cfgs.items()},
              separators=(",", ":")),
          s=f"{secs:.1f}", subprocess_decode=CTC_SUBPROCESS_FAMILY,
          subprocess_ply="as_reference", subprocess_s=f"{sub_s:.1f}")

    # (n3) the parity harness, codec "ours", at r04 on (n1)'s inputs
    out = EVAL_DIR / "parity"
    t0 = time.perf_counter()
    with _repo_on_path(), contextlib.redirect_stdout(io.StringIO()):
        rows = parity.main(["--cond", *PARITY_R04, "--rates",
                            PARITY_RATE, "--codecs", "ours",
                            "--out", str(out)])
    secs = time.perf_counter() - t0
    for row in rows:
        _check("error" not in row, f"(n3) {row}")
        want = PARITY_R04[row["cond"]]
        size = (out / "runs" / f"{row['cond']}.{PARITY_RATE}.ours.bin"
                ).stat().st_size
        for k in ("points", "geom_bpp", "attr_bpp", "total_bpp"):
            _check(row[k] == want[k], f"(n3) {row['cond']} {k}: {row[k]!r},"
                   f" the JAX harness gives {want[k]!r}")
        _check(size == want["bytes"], f"(n3) {row['cond']}: {size} B, the "
               f"JAX harness writes {want['bytes']} B")
        for k in ("d1_psnr", "d2_psnr", "y_psnr"):
            _check((row[k] is None) == (want[k] is None) and (
                row[k] is None or abs(row[k] - want[k]) <= PSNR_TOL_DB),
                f"(n3) {row['cond']} {k}: {row[k]!r}, the JAX harness "
                f"gives {want[k]!r} (tol {PSNR_TOL_DB} dB)")
        _line("n", stage="n3_parity", cond=row["cond"], rate=row["rate"],
              codec=row["codec"], points=row["points"], bytes=size,
              geom_bpp=row["geom_bpp"], attr_bpp=row["attr_bpp"],
              d1_psnr=row["d1_psnr"], d2_psnr=row["d2_psnr"],
              y_psnr=row["y_psnr"], vs_jax_harness="bytes_exact_psnr_1e-6",
              enc_user_s=row["enc_user_s"], dec_user_s=row["dec_user_s"],
              enc_mpts_user=row["enc_mpts"], dec_mpts_user=row["dec_mpts"],
              enc_wall_s=f"{row['enc_wall_s']:.3f}",
              dec_wall_s=f"{row['dec_wall_s']:.3f}",
              enc_mpts_wall=f"{row['points'] / row['enc_wall_s'] / 1e6:.4f}",
              dec_mpts_wall=f"{row['points'] / row['dec_wall_s'] / 1e6:.4f}",
              card=repr(smi))
    _check(sorted(r["cond"] for r in rows) == sorted(PARITY_R04),
           f"(n3) rows for {[r['cond'] for r in rows]}")
    _line("n", stage="n3_parity", rows=len(rows),
          reports=",".join(sorted(p.name for p in out.iterdir()
                                  if p.is_file())), s=f"{secs:.1f}")

    # (n4) mesh scaling on every visible card: each mesh size's payload
    # bytes equal the host engine's and the JAX script's
    backend = None if device.type == "cuda" else "cpu"
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        mrows = mesh_scaling.main(backend)
    secs = time.perf_counter() - t0
    fp_launches = _launches("fwd_blocks_int")["fwd_blocks_int"]
    # two calls a mesh size (warm, timed), one launch a device each
    _check(backend == "cpu" or fp_launches == 2 * sum(
        r["devices"] for r in mrows),
           f"(n4) raht_fwd_blocks_int launched {fp_launches} times over "
           f"mesh sizes {[r['devices'] for r in mrows]}")
    pos = np.random.default_rng(0).integers(0, 1 << 9, (200_000, 3),
                                            dtype=np.int64)
    codes = np.unique(morton.encode(pos))
    _check(len(mrows) > 0 and [r["devices"] for r in mrows] == list(
        mesh_scaling.mesh_sizes(backend)), f"(n4) mesh sizes {mrows}")
    for r in mrows:
        nd = r["devices"]
        host_bytes = _host_geom_bytes(codes, nd, 9)
        _check(r["geom_bytes"] == host_bytes == MESH_GEOM_BYTES[nd],
               f"(n4) {nd} devices: {r['geom_bytes']} B, the host engine "
               f"{host_bytes} B, the JAX script {MESH_GEOM_BYTES[nd]} B")
        _line("n", stage="n4_mesh_scaling", **r,
              vs_host_engine="identical", vs_jax_script="identical")
    _line("n", stage="n4_mesh_scaling", sizes=len(mrows),
          fwd_blocks_int_launches=fp_launches, s=f"{secs:.1f}",
          phase_s=f"{time.perf_counter() - t_phase:.1f}", card=repr(smi))


def entry_sha256(compact, counts):
    """SHA-256 of ``entry()``'s outputs: the compacted entries, then the
    per-level counts, as int32 bytes."""
    return hashlib.sha256(
        compact.cpu().numpy().astype(np.int32).tobytes()
        + counts.cpu().numpy().astype(np.int32).tobytes()).hexdigest()


def phase_o(smi):
    """The port's benchmark as a user runs it, in a process of its own,
    its line held to the pins; then the single-card ``entry()`` on the
    default CUDA device, held to the JAX entry's hash."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.entry import entry

    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mpeg_pcc_tmc13_tpu_torch.bench"], cwd=REPO,
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    _check(res.returncode == 0, f"(o) the bench exited {res.returncode}: "
           f"{res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    _check(lines, f"(o) the bench printed nothing: {res.stderr[-3000:]}")
    got = json.loads(lines[-1])
    with open(REPO / "BENCH_r05.json") as f:
        tpu_keys = set(json.load(f)["parsed"]) - {"device_attr_error"}
    missing = sorted((tpu_keys | set(BENCH_PORT_KEYS)) - set(got))
    _check(not missing, f"(o) the bench line lacks {missing}")
    errors = sorted(k for k in got if k.endswith("_error"))
    _check(not errors, f"(o) the bench line has {errors}")
    for key, pin in (*BENCH_SIZES.items(),
                     ("device_attr_bpp", DEVICE_ATTR_BPP)):
        _check(got[key] == pin, f"(o) {key} {got[key]}, pinned {pin}")
    _check(got["device_numerics_ok"] is True and got["device_attr_ok"] is True,
           f"(o) device_numerics_ok {got['device_numerics_ok']}, "
           f"device_attr_ok {got['device_attr_ok']}")
    _check(got["device"] == torch.cuda.get_device_name(0),
           f"(o) the bench ran on {got['device']!r}")
    _line("o", stage="bench", wall_s=f"{wall:.1f}", sizes="pinned",
          card=repr(smi))
    print("[o] bench " + json.dumps(got), flush=True)

    fn, (codes,) = entry()
    _check(codes.device.type == "cuda", f"(o) entry() put its codes on "
           f"{codes.device}")
    t0 = time.perf_counter()
    compact, counts = fn(codes)
    sha = entry_sha256(compact, counts)
    secs = time.perf_counter() - t0
    _check(sha == ENTRY_SHA256, f"(o) entry() outputs hash to {sha}, the "
           f"JAX entry's to {ENTRY_SHA256}")
    _line("o", stage="entry", device=str(codes.device),
          nodes=compact.shape[0], first_call_s=f"{secs:.3f}",
          vs_jax_entry="identical", card=repr(smi))


SYNC_CALLS = ("aten::_local_scalar_dense", "aten::item", "aten::nonzero",
              "aten::index", "aten::_to_copy", "cudaMemcpyAsync",
              "cudaStreamSynchronize", "cudaDeviceSynchronize")


def _profile_rans(device, pos, depth, npoints, payload, top=8):
    """One warm rANS encode and one warm decode under ``torch.profiler``,
    each on lines of its own: the ``top`` device operations by time, the
    device-busy share of the wall, and the host calls that wait for the
    device.  Measures only; fails if the profiler traced no device
    operation."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpeg_pcc_tmc13_tpu_torch.models import geometry_rans as gr
    runs = (("rans_encode", lambda: gr.encode(pos, depth, device=device)),
            ("rans_decode", lambda: gr.decode(payload, npoints, depth,
                                              device=device)))
    for what, fn in runs:
        fn()
        _sync(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            _sync(device)
            wall_us = (time.perf_counter() - t0) * 1e6
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        plain_wall_us = (time.perf_counter() - t0) * 1e6
        dev_ops, host = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                n, us = dev_ops.get(e.name, (0, 0.0))
                dev_ops[e.name] = (n + 1, us + e.time_range.elapsed_us())
            elif e.name in SYNC_CALLS:
                n, us = host.get(e.name, (0, 0.0))
                host[e.name] = (n + 1, us + e.time_range.elapsed_us())
        _check(dev_ops, f"torch.profiler traced no device operation in "
               f"{what}")
        busy_us = sum(us for _, us in dev_ops.values())
        _line("f", profile=what, wall_ms=f"{wall_us / 1e3:.3f}",
              wall_unprofiled_ms=f"{plain_wall_us / 1e3:.3f}",
              device_busy_ms=f"{busy_us / 1e3:.3f}",
              device_busy_share=f"{busy_us / wall_us:.3f}",
              device_ops=sum(n for n, _ in dev_ops.values()),
              distinct=len(dev_ops))
        ranked = sorted(dev_ops.items(), key=lambda kv: -kv[1][1])[:top]
        for rank, (name, (n, us)) in enumerate(ranked, 1):
            _line("f", profile=what, rank=rank, device_ms=f"{us / 1e3:.4f}",
                  calls=n, op=repr(name[:100]))
        _line("f", profile=what, host_calls_that_wait=json.dumps(
            {k: {"calls": n, "ms": round(us / 1e3, 3)}
             for k, (n, us) in sorted(host.items())},
            separators=(",", ":")))


def _rans_times(run):
    """The three rANS kernels against their plain versions at (g)'s
    shapes, in turns, with each bound from what this run's data needs
    and the serial chain that floors each below its bound."""
    from mpeg_pcc_tmc13_tpu_torch.ops import rans_lanes as L
    times = {}
    G, K = run.f_steps.shape
    args = (run.occ2, run.ctx2, run.counts, run.K)
    k, p, d = _turns("table_pass", lambda: L.table_pass(*args),
                     lambda: L.table_pass_ref(*args), reps_plain=SLOW_REPS,
                     steps=G, lanes=K, symbols=sum(run.counts))
    # occupancy and context of each symbol in, f and c out, the histogram
    nbytes = {"table_pass": sum(run.counts) * 8
              + _io_bytes(run.f_steps, run.c_steps, run.hist)}
    times["table_pass"] = (k, p, d, *_bound_ms(nbytes["table_pass"]))
    row, occs, wins = run.busiest
    _line("f", kernel="table_pass",
          chain=f"busiest_row_{row}:{occs}_occurrences_in_{wins}_windows")
    args = (run.f_steps, run.c_steps, run.nvalid)
    k, p, d = _turns(
        "encode_emit", lambda: L.encode_emit(*args),
        lambda: L.encode_emit_ref(*args), reps_plain=SLOW_REPS,
        steps=G, lanes=K)
    nbytes["encode_emit"] = _io_bytes(*args, *L.encode_emit(*args))
    times["encode_emit"] = (k, p, d, *_bound_ms(nbytes["encode_emit"]))
    # the chain that floors it: the step's dependent latency, from one
    # warp running the kernel's step alone on register parameters
    cycles, ns = min(L.emit_chain_probe(run.f_steps.device)
                     for _ in range(3))
    chain_ms = G * ns * 1e-6
    _line("f", kernel="encode_emit", chain=f"{G}_dependent_steps_per_lane",
          step_cycles=f"{cycles:.2f}", step_ns=f"{ns:.3f}",
          step_from="one_warp_timing_of_the_chain_alone",
          chain_bound_ms=f"{chain_ms:.4f}",
          share_of_chain_bound=f"{chain_ms / d:.3f}")
    rec = run.rec
    st_k, st_p = _new_level_state(rec), _new_level_state(rec)
    k, p, d = _turns(
        "decode_level", lambda: _replay_levels(L.decode_level, rec, st_k),
        lambda: _replay_levels(L.decode_level_ref, rec, st_p),
        reps_plain=SLOW_REPS, levels=len(rec.counts), lanes=K)
    nbytes["decode_level"], touched = _level_bytes(rec)
    times["decode_level"] = (k, p, d, *_bound_ms(nbytes["decode_level"]))
    _line("f", kernel="decode_level",
          chain=f"{G}_dependent_tiles_in_{run.windows}_windows",
          touched_rows_mean=f"{sum(touched) / len(touched):.1f}",
          touched_rows_max=max(touched))
    for name in ("table_pass", "encode_emit", "decode_level"):
        k, p, d, bound, by = times[name]
        _line("f", kernel=name, pass_ms=f"{k:.4f}", device_ms=f"{d:.4f}",
              bound_ms=f"{bound:.4f}", bound_by=by,
              share=f"{bound / d:.4f}", bytes=nbytes[name])
    return times, {"encode_emit": chain_ms}


def _level_bytes(rec):
    """What ``decode_level`` must move over the recorded decode, per
    launch (one a level): the context id in and the symbol out of each
    decoded symbol, the words it pops, the lane states in and out, and
    each context row the level touches, once: its 256 counts in and out
    and its 256 table entries in and out (the rows stay on chip across
    the level's refresh windows).  Returns (bytes, touched rows per
    refresh window)."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import rans_lanes as L
    win = L.UPD_TILES * rec.K
    nbytes = 0
    touched = []
    for l, (ctx_row, count) in enumerate(zip(rec.ctx_rows, rec.counts)):
        if not count:
            continue                        # no launch
        ctx = ctx_row[:count].long()
        popped = int(rec.starts[l + 1][1]) - int(rec.starts[l][1])
        nbytes += (count * 8 + popped * 4 + 2 * _io_bytes(rec.starts[l][0])
                   + torch.unique(ctx).numel() * 256 * 4 * 4)
        touched += [torch.unique(ctx[a:a + win]).numel()
                    for a in range(0, count, win)]
    return nbytes, touched


# ---- (q) the colour brick's float predicted RAHT on the card ------------

FLOAT_BODY_SEED = 2_718_281_828   # the body frame of (q)
FLOAT_KERNELS = ("raht_float_truth", "raht_float_predict",
                 "raht_float_inverse")
FLOAT_STEP = 8.0                  # (q1)'s quantiser step
FLOAT_SPIN_CYCLES = 4_000_000     # ~2 ms of spin ahead of a timed launch


def _float_bytes(name, mp, mc, nc, pairs, coarse=False, values=True):
    """Bytes a float loop kernel must move once at a level: its plan rows
    (gather and three offsets; the predictor's neighbour tables and skip
    base), the weights, and 8 bytes a value it reads or writes."""
    plan = mp * (8 * 8 + 3 * 8) + mc * 8 + mp * 8
    if name == "raht_float_truth":
        return plan + ((mc + mp + pairs) * nc * 8 if values else 0)
    if name == "raht_float_predict":
        return (plan + mp * (18 * 8 + 18 + 1) + (16 * mp if coarse else 0)
                + mp * nc * 8 + (3 if values else 1) * pairs * nc * 8)
    return plan + mp * nc * 8 + 2 * pairs * nc * 8 + mc * nc * 8


def _event_ms(times, name, fn, *args):
    """Run ``fn(*args)`` between two CUDA events; add its ms to
    ``times[name]``: the wall time of the call, its host work and launch
    included, not the kernel's device time."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    fn(*args)
    ev[1].record()
    torch.cuda.synchronize()
    times[name] = times.get(name, 0.0) + ev[0].elapsed_time(ev[1])


def _kernel_event_ms(times, name, fn, *args):
    """Run the launcher ``fn(*args)`` behind a spin kernel
    (``torch.cuda._sleep``), between two CUDA events recorded after the
    spin: the launcher's host work overlaps the spin, so the events time
    the kernel on the device alone; add its ms to ``times[name]``.  Fails
    where the host work outlasted the spin."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(FLOAT_SPIN_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    fn(*args)
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    spin_ms = ev[0].elapsed_time(ev[1])
    _check(host_ms < spin_ms, f"(q1) {name}: the launch's host work "
           f"({host_ms:.3f} ms) outlasted the spin ({spin_ms:.3f} ms)")
    times[name] = times.get(name, 0.0) + ev[1].elapsed_time(ev[2])


def _float_timed(times, launchers, timer=_event_ms):
    return tuple((lambda *a, n=n, f=f: timer(times, n, f, *a))
                 for n, f in zip(FLOAT_KERNELS, launchers))


def _float_twins(diffs, nbytes):
    """Launchers that run each kernel and its plain version on the same
    inputs (the plain one first, into outputs of its own, since the
    encoder's prediction writes its residual over the truth rows), keep
    the largest absolute difference of any output and the bytes the
    kernel must move, under the kernel's name."""
    import torch
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_float_device as rfd

    def fresh(ts):
        return None if ts is None else [torch.empty_like(t) for t in ts]

    def note(name, pairs, nb):
        d = max([float((a.double() - b.double()).abs().max())
                 for a, b in pairs if a is not None and a.numel()] + [0.0])
        diffs[name] = max(diffs.get(name, 0.0), d)
        nbytes[name] = nbytes.get(name, 0) + nb

    def truth(p, off, mp, vals, w_c, dc, w_p, rows):
        (w2,), rows2 = fresh([w_p]), fresh(rows)
        dc2 = None if dc is None else fresh([dc])[0]
        rfd.truth_ref(p, off, mp, vals, w_c, dc2, w2, rows2)
        rfd._cuda_truth(p, off, mp, vals, w_c, dc, w_p, rows)
        pairs = [(w_p, w2)]
        if vals is not None:
            pairs += [(dc, dc2)] + list(zip(rows, rows2))
        note("raht_float_truth", pairs, _float_bytes(
            "raht_float_truth", mp, p["pidx"].numel(),
            1 if vals is None else vals.shape[1],
            sum(r.shape[0] for r in rows or ()), values=vals is not None))

    def predict(p, off, mp, recon_p, w_p, w_c, coarser, t0, weights,
                truth_rows, res, pred):
        res2, pred2 = fresh(res), fresh(pred)
        rfd.predict_ref(p, off, mp, recon_p, w_p, w_c, coarser, t0, weights,
                        truth_rows, res2, pred2)
        rfd._cuda_predict(p, off, mp, recon_p, w_p, w_c, coarser, t0,
                          weights, truth_rows, res, pred)
        pairs = list(zip(pred, pred2)) + list(zip(res or (), res2 or ()))
        note("raht_float_predict", pairs, _float_bytes(
            "raht_float_predict", mp, p["pidx"].numel(), recon_p.shape[1],
            sum(r.shape[0] for r in pred), coarse=coarser is not None,
            values=res is not None))

    def inverse(p, off, mp, recon_p, w_c, pred, deq, recon_c):
        (r2,) = fresh([recon_c])
        rfd.inverse_ref(p, off, mp, recon_p, w_c, pred, deq, r2)
        rfd._cuda_inverse(p, off, mp, recon_p, w_c, pred, deq, recon_c)
        note("raht_float_inverse", [(recon_c, r2)], _float_bytes(
            "raht_float_inverse", mp, recon_c.shape[0], recon_c.shape[1],
            sum(r.shape[0] for r in pred)))

    return truth, predict, inverse


@contextlib.contextmanager
def _numpy_colour():
    """The colour brick's numpy path while the block runs: the frame
    codec hands the brick no device."""
    from mpeg_pcc_tmc13_tpu_torch.runtime import decoder, encoder
    before = encoder.cuda_or_none, decoder.cuda_or_none
    encoder.cuda_or_none = decoder.cuda_or_none = lambda d: None
    try:
        yield
    finally:
        encoder.cuda_or_none, decoder.cuda_or_none = before


class _Sink:
    def __init__(self):
        self.spans, self.counters = {}, {}


@contextlib.contextmanager
def _float_launches(rfd, counts):
    """Count the float loop's launches in each card-loop encode and
    decode the block makes through ``models/attr_raht``: ``counts``
    gets (side, depth, {kernel: launches}) a call."""
    before = rfd.encode, rfd.decode

    def counted(side, fn, depth_at):
        def run(*a, **kw):
            _reset_launches()
            out = fn(*a, **kw)
            counts.append((side, a[depth_at], _launches(*FLOAT_KERNELS)))
            return out
        return run
    rfd.encode = counted("encode", before[0], 2)
    rfd.decode = counted("decode", before[1], 1)
    try:
        yield
    finally:
        rfd.encode, rfd.decode = before


def phase_q(device, seed=FLOAT_BODY_SEED):
    """(q) the colour brick's float predicted RAHT on the card at the
    body frame of the benchmark's ``vox10_body_cli`` configuration.
    Returns ({kernel: (wall ms, plain ms, device ms, bound ms, bound
    by)}, {kernel: launches of the CLI path's encode and decode},
    {kernel: max abs difference from its plain version})."""
    from mpeg_pcc_tmc13_tpu_torch.models import attr_raht
    from mpeg_pcc_tmc13_tpu_torch.ops import raht as raht_ops
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_float_device as rfd
    from mpeg_pcc_tmc13_tpu_torch.utils import timing
    from pccbench.codecs import tmc3_cli
    from pccbench.frames import make_frames
    from pccbench.spans import Clock

    cfg = json.loads((REPO / "pccbench/configs/vox10_body_cli.json")
                     .read_text())
    t0 = time.perf_counter()
    fr = make_frames(dict(cfg, frames=1), seed)[0]
    codes, rgb = fr.codes, fr.values
    depth = attr_raht._tree_depth(codes)
    _line("q", points=codes.size, depth=depth,
          frame_s=f"{time.perf_counter() - t0:.1f}")
    args = ((2, 6), (9, 3, 1), device)

    # (q1) each kernel against its plain version at every launch of an
    # encode and a decode of the frame's RGB (a plain quantiser), and the
    # residuals and reconstruction against numpy's loop, bit for bit
    def quantiser(seen):
        def quant(arr, tag):
            seen.append(arr.copy())
            return np.round(arr / FLOAT_STEP)
        return quant

    def dequant(q, tag):
        return FLOAT_STEP * q

    def reader(rows):
        coded = iter([np.round(r / FLOAT_STEP) for r in rows])
        return lambda n, tag: next(coded)

    diffs, nbytes = {}, {}
    _reset_launches()
    twins = _float_twins(diffs, nbytes)
    card_rows, spec_rows = [], []
    rfd.encode(codes, rgb, depth, quantiser(card_rows), dequant, *args,
               twins)
    enc_bytes = dict(nbytes)
    rec = rfd.decode(codes, depth, reader(card_rows), dequant, 3, *args,
                     twins)
    raht_ops.forward_predicted(codes, rgb, depth, quantiser(spec_rows),
                               dequant)
    spec = raht_ops.inverse_predicted(codes, depth, reader(spec_rows),
                                      dequant, 3)
    _check(len(card_rows) == len(spec_rows) == 1 + 3 * depth
           and all(np.array_equal(a, b)
                   for a, b in zip(card_rows, spec_rows)),
           "(q1) the card's residual rows are not numpy's")
    _check(np.array_equal(rec, spec), "(q1) the card's reconstruction is "
           "not numpy's")
    launches = _launches(*FLOAT_KERNELS)
    _check(launches == {"raht_float_truth": 2 * depth,
                        "raht_float_predict": 2 * depth,
                        "raht_float_inverse": 2 * depth - 1},
           f"(q1) launches {launches}")
    for name in FLOAT_KERNELS:
        _check(diffs[name] == 0.0, f"(q1) {name} differs from its plain "
               f"version by {diffs[name]}")
    # a warm encode through the kernels, then through the plain
    # versions, each launcher call between CUDA events (wall time: host
    # work and launch included), then one through the kernels each
    # behind a spin (the kernels' own device time; a torch.profiler
    # trace here would leave the later ones of (f) empty)
    ktimes, ptimes, dev = {}, {}, {}
    rfd.encode(codes, rgb, depth, quantiser([]), dequant, *args,
               _float_timed(ktimes, rfd.CUDA_LAUNCHERS))
    rfd.encode(codes, rgb, depth, quantiser([]), dequant, *args,
               _float_timed(ptimes, rfd.PLAIN_LAUNCHERS))
    rfd.encode(codes, rgb, depth, quantiser([]), dequant, *args,
               _float_timed(dev, rfd.CUDA_LAUNCHERS, _kernel_event_ms))
    times = {}
    for name in FLOAT_KERNELS:
        bound, by = _bound_ms(enc_bytes[name])
        times[name] = (ktimes[name], ptimes[name], dev[name], bound, by)
        _line("q1", kernel=name, max_abs_err=diffs[name],
              encode_device_ms=f"{dev[name]:.4f}",
              encode_bound_ms=f"{bound:.4f}",
              encode_launch_wall_ms=f"{ktimes[name]:.4f}",
              encode_plain_wall_ms=f"{ptimes[name]:.2f}")

    # (q2) the frame through tmc3-cuda's path: card loop, numpy path;
    # the card path's launches counted in its own encode and decode
    out, counts = {}, []
    for path in ("card", "numpy"):
        codec = tmc3_cli.make(cfg, None, [str(device)], Clock(False))
        sinks = _Sink(), _Sink()
        with (_numpy_colour() if path == "numpy"
              else _float_launches(rfd, counts)):
            t1 = time.perf_counter()
            with timing.tracing(sinks[0], "encode"):
                enc = codec.encode(codes, rgb)
            t2 = time.perf_counter()
            with timing.tracing(sinks[1], "decode"):
                dcodes, dvals = codec.decode(enc.geom, enc.attr, codes.size)
            t3 = time.perf_counter()
        _check(np.array_equal(dcodes, codes), f"(q2) {path}: positions")
        sp = {**sinks[0].spans, **sinks[1].spans}
        ct = {**sinks[0].counters, **sinks[1].counters}
        want = 1 if path == "card" else 0
        _check(ct["encode.attr.card_bricks"] == want
               and ct["decode.attr.card_bricks"] == want,
               f"(q2) {path}: card bricks {ct}")
        out[path] = (enc, dvals)
        if path == "card":
            d = counts[0][1] if counts else -1

            def want(inverse):
                return {"raht_float_truth": d, "raht_float_predict": d,
                        "raht_float_inverse": inverse}
            _check(counts == [("encode", d, want(d - 1)),
                              ("decode", d, want(d))],
                   f"(q2) the CLI path's launches {counts}")
            for side, d, n in counts:
                _line("q2", path=path, side=side, depth=d,
                      **{k.replace("raht_float_", "launches_"): v
                         for k, v in n.items()})
        _line("q2", path=path, encode_s=f"{t2 - t1:.3f}",
              decode_s=f"{t3 - t2:.3f}",
              attr_brick_encode_ms=f"{1e3 * sp['encode.attr.brick']:.1f}",
              attr_quant_encode_ms=f"{1e3 * sp['encode.attr.quant']:.1f}",
              attr_brick_decode_ms=f"{1e3 * sp['decode.attr.brick']:.1f}",
              attr_bytes=len(enc.attr))
    (ec, vc), (en, vn) = out["card"], out["numpy"]
    _check(ec.attr == en.attr, "(q2) the card loop's attribute bricks "
           "differ from the numpy path's")
    _check(ec.geom == en.geom, "(q2) the geometry units differ")
    _check(np.array_equal(vc, vn), "(q2) the decoded RGB differs")

    # (q3) tmc3-cuda --mode=1, a process of its own, on the card's stream
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    stream, ply_out = CLI_DIR / "float_card.bin", CLI_DIR / "float_card.ply"
    stream.write_bytes(ec.geom + ec.attr)
    secs, _ = _cli_process(["--mode=1", f"--compressedStreamPath={stream}",
                            f"--reconstructedDataPath={ply_out}"])
    got = np.asarray(_decoded(ply_out, codes), dtype=np.int64)
    _check(np.array_equal(got, vc),
           "(q3) tmc3-cuda --mode=1 decoded other colours")
    _line("q3", cli_decode_process_s=f"{secs:.1f}", same_cloud=True)
    launches = {k: sum(n[k] for _, _, n in counts) for k in FLOAT_KERNELS}
    return times, launches, diffs


# the kernels whose registers, shared memory and spills (b) prints, by a
# part of their (possibly mangled) entry names
PTXAS_KERNELS = ("raht_fp_group_kernel", "octree_expand_count_kernel",
                 "octree_expand_level_kernel", "plan_blocks_kernel",
                 "raht_float_predict_kernel")


def _ptxas_report(so, names):
    """{entry: {registers, static_smem_bytes, spill_stores, spill_loads}}
    of the entries whose names contain one of ``names``, from ptxas's
    report in the build log beside the library (``-Xptxas=-v``); the
    kernel's ``<src>`` instance is the one that writes source rows."""
    out, current = {}, None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = next((n for n in names if n in m.group(1)), None)
            if current and "Lb1EE" in m.group(1):
                current += "<src>"
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(current, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m:
            out.setdefault(current, {}).update(
                registers=int(m.group(1)),
                static_smem_bytes=int(m.group(2) or 0))
            current = None
    _check(all(any(n in k for k in out) for n in names),
           f"(b) ptxas reported none of some kernels: {sorted(out)}")
    return out


def main() -> int:
    t_start = time.perf_counter()
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
    for name, report in _ptxas_report(so, PTXAS_KERNELS).items():
        _line("b", kernel=name, **report)
    _line("b", kernel="raht_fp_group_kernel",
          dynamic_smem_bytes_c3=_kernels.load().raht_fp_group_smem_bytes(3))

    errs = phase_c(device)                                     # (c)
    uniq, colors = bench_cloud()
    r, launches = phase_d(device, uniq, BENCH_DEPTH, colors)   # (d)
    p_errs, headline = phase_p(device, uniq, BENCH_DEPTH,      # (p)
                               colors)
    errs.update(p_errs)
    q_times, q_launches, q_errs = phase_q(device)              # (q)
    launches.update(q_launches)
    errs.update(q_errs)
    phase_e(device)                                            # (e)
    rans, rans_launches, rans_errs = phase_g(                  # (g)
        device, uniq, BENCH_DEPTH, len(r.geom_payload))
    launches.update(rans_launches)
    errs.update(rans_errs)
    phase_h(device)                                            # (h)
    phase_i(device, uniq, BENCH_DEPTH)                         # (i)
    phase_j(device, uniq, BENCH_DEPTH, r.geom_payload)         # (j)
    phase_k(device, uniq, BENCH_DEPTH, colors, smi)            # (k)
    phase_l(device, uniq, colors, smi)                         # (l)
    m_times, m_launches, m_errs = phase_m(                     # (m)
        device, uniq, BENCH_DEPTH, colors, smi)
    launches.update(m_launches)
    errs.update(m_errs)
    phase_n(device, smi)                                       # (n)
    phase_o(smi)                                               # (o)
    times, chain_ms = phase_f(device, uniq, BENCH_DEPTH,       # (f)
                              colors, rans, errs, headline)
    times.update(m_times)
    times.update(q_times)

    _line("z", smoke_s=f"{time.perf_counter() - t_start:.1f}")
    kernels = []
    for key, (name, src, replaces) in KERNELS.items():
        ms, plain_ms, device_ms, bound_ms, bound_by = times[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mpeg_pcc_tmc13_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
            "device_ms": device_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "chain_bound_ms": chain_ms.get(key),
            "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
