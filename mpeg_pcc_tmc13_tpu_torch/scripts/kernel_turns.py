"""Device times of the bench headline's group and expansion kernels on a
CUDA card, for comparing two versions of them in turns.

    python mpeg_pcc_tmc13_tpu_torch/scripts/kernel_turns.py [--root DIR]
        [--points N] [--depth D] [--reps R] [--codes FILE.npy]

On the bench's cloud (``make_surface_cloud(1_000_000, 11)``, 889,682
unique codes, colours from ``_colors_for``, qp 22), or with ``--codes``
on the sorted unique Morton codes saved in an ``.npy`` file (a frame of
any source, at ``--depth``), it times, each as a CUDA graph captured
once and replayed ``--reps`` times between CUDA events after a warm-up
(so host issue drops out):

* ``raht_fp_group``: ``DeviceFpRaht``'s 11 encode groups and its 11
  decode groups as the card loop runs them (``_enc_group_kernels``,
  ``_decode_kernels``), and the largest encode group alone (the finest,
  with the means handed on, its arguments recorded from the loop);
* ``octree_expand``: ``decode_expand_stream`` on the cloud's occupancy
  stream, and its largest level alone as ``_expand_level`` (the rANS
  decoder's form: a counting launch and the level); where the imported
  version has it, one link of the level chain alone
  (``expand_chain_probe``: an empty launch on the level launches' grid);
* ``raht_fp_truth_level`` (a kernel that neither version changes, as a
  control): the 11 truth levels;
* where the imported version has it, the planner ``build_plan`` alone
  (``plan_times``: not a graph, it reads its counts on the host).

Every kernel's output is checked against its plain version first.
``--root`` imports the package from another checkout (for example the
parent commit unpacked into a git-ignored directory), so two versions
are timed by the same script in one call.  Prints one JSON line with the
card's name and power limit.  Needs a CUDA card (exits 1 without).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def _graph_ms(fn, reps):
    """Device ms of one ``fn()``, captured once as a CUDA graph."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def largest_encode_group(dv, truth):
    """The finest (largest) encode group as ``dv``'s card loop launches
    it (the means handed on): ``(args, kwargs)`` of its ``_cuda_group``
    call, recorded from one run of ``_enc_group_kernels`` over ``truth``
    (``_truth_kernels``' outputs)."""
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
    recorded = []

    def record(*a, **kw):
        recorded.append((a, kw))
        fpd._cuda_group(*a, **kw)
    dv._enc_group_kernels(*truth, (fpd._cuda_truth, record))
    return recorded[-1]


def _wall_ms(fn, reps):
    """Median host ms of ``fn()`` between two synchronisations."""
    import statistics
    import time

    import torch
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ts)


def plan_times(uniq, depth, dev, reps):
    """The planner alone on ``uniq``: ``build_plan``'s plan checked tensor
    for tensor against the host's ``build_fp_plan`` + ``plans_to_torch``
    and ``row_offsets``; then its wall (codes on the card, counts read,
    last kernel done), its three kernels' device ms (profiler), its byte
    bound (the plan's tensors written once and the codes read, at 3.35
    TB/s) and launches, the codes' upload, the plain version
    ``build_plan_ref`` on the card, and the host planner with its
    upload."""
    import torch

    from mpeg_pcc_tmc13_tpu_torch.ops import _kernels
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_plan as rp
    codes = torch.as_tensor(uniq, device=dev)
    got = rp.build_plan(codes, depth)
    host = fpd.build_fp_plan(uniq, depth)
    spec = fpd.plans_to_torch(host, dev)
    if got.n_roots != host[-1].mp or got.pair_counts != [
            (h.flat_z.size, h.flat_y.size, h.flat_x.size) for h in host]:
        raise AssertionError("build_plan's counts differ from the host's")
    for p, offs, q in zip(got.plans, got.offsets, spec):
        _same("build_plan", tuple(p[k] for k in q) + offs,
              tuple(q.values()) + rp.row_offsets(q))
    plan_bytes = codes.numel() * 8 + sum(
        t.numel() * t.element_size()
        for p, offs in zip(got.plans, got.offsets)
        for t in list(p.values()) + list(offs))
    out = {"plan_bytes": plan_bytes,
           "plan_bound_ms": plan_bytes / 3.35e9}
    _kernels.reset_launch_counts()
    out["plan_ms"] = _wall_ms(lambda: rp.build_plan(codes, depth), reps)
    out["plan_launches"] = _kernels.LAUNCHES["raht_fp_plan"] / reps
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            rp.build_plan(codes, depth)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        for name in ("plan_count", "plan_scatter", "plan_blocks"):
            if f"{name}_kernel" in ev.key:
                us = getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
                out[f"{name}_ms"] = us / 1e3 / reps
    out["plan_kernels_ms"] = sum(out.get(f"{n}_ms", 0.0) for n in (
        "plan_count", "plan_scatter", "plan_blocks"))
    out["plan_upload_ms"] = _wall_ms(
        lambda: torch.as_tensor(uniq, device=dev), reps)
    out["plain_plan_ms"] = _wall_ms(
        lambda: rp.build_plan_ref(codes, depth), max(1, reps // 4))
    out["host_plan_ms"] = _wall_ms(lambda: fpd.build_fp_plan(uniq, depth),
                                   3)
    out["host_upload_ms"] = _wall_ms(
        lambda: [rp.row_offsets(p) for p in fpd.plans_to_torch(host, dev)],
        3)
    return out


def _cloud(path, points, depth):
    """The codes: the bench cloud of ``points`` at ``depth``, or those
    saved at ``path`` (sorted, unique, int64)."""
    import numpy as np

    from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt
    if path is None:
        return rt.sorted_unique_codes(rt.make_surface_cloud(points, depth))
    return np.load(path).astype(np.int64)


def _same(name, got, want):
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want) or not all(
            torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name} differs from its plain version")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--depth", type=int, default=11)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--codes", default=None,
                    help="an .npy file of sorted unique Morton codes at "
                    "--depth, used in place of the bench cloud")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    from mpeg_pcc_tmc13_tpu_torch.models.attr_raht import qp_to_step_q16
    from mpeg_pcc_tmc13_tpu_torch.ops import octree
    from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
    from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt

    dev = torch.device("cuda:0")
    depth, reps = args.depth, args.reps
    uniq = _cloud(args.codes, args.points, depth)
    colors = rt._colors_for(uniq, depth)
    n = uniq.size
    out = {"points": int(n), "depth": depth, "reps": reps,
           "root": Path(args.root).resolve().name,
           "cloud": Path(args.codes).stem if args.codes else "bench"}

    # the expansion
    codes = torch.as_tensor(uniq, device=dev)
    cap = -(-n * depth // 64) * 64        # every level's nodes fit
    hdr = octree.encode_occ_u8_hdr_ref(codes, depth, cap)
    counts = hdr[:4 * depth].view(torch.int32)
    total = int(counts.to(torch.int64).sum())
    stream = (hdr[4 * depth:4 * depth + total].contiguous(), counts.clone(),
              depth, n)
    _same("decode_expand_stream", octree.decode_expand_stream(*stream),
          octree.decode_expand_stream_ref(*stream))
    out["expand_stream_ms"] = _graph_ms(
        lambda: octree.decode_expand_stream(*stream), reps)
    if hasattr(octree, "expand_chain_probe"):
        links = depth + 1               # a counting launch, one a level
        out["chain_link_ms"] = _graph_ms(
            lambda: [octree.expand_chain_probe(n, dev)
                     for _ in range(links)], reps) / links
    # the largest level as _expand_level: its nodes from the plain chain
    offs = torch.cumsum(counts.to(torch.int64), 0) - counts.to(torch.int64)
    row = torch.arange(n, dtype=torch.int64, device=dev)
    nodes = torch.full((n,), octree.I64_MAX, dtype=torch.int64, device=dev)
    nodes[0] = 0
    for l in range(depth):
        idx = (offs[l] + row).clamp(max=stream[0].numel() - 1)
        occ = torch.where(row < counts[l], stream[0][idx].to(torch.int64), 0)
        if l < depth - 1:
            nodes = octree._expand_level_ref(nodes, occ, n)[0]
    _same("_expand_level", octree._expand_level(nodes, occ, n),
          octree._expand_level_ref(nodes, occ, n))
    out["expand_largest_level_ms"] = _graph_ms(
        lambda: octree._expand_level(nodes, occ, n), reps)

    # the fixed-point loop
    steps = [qp_to_step_q16(22)] * colors.shape[1]
    dv = fpd.DeviceFpRaht(uniq, depth, steps, device=dev)
    vals = torch.as_tensor(colors, dtype=torch.int64, device=dev)
    truth = dv._truth_kernels(vals, fpd.CUDA_LAUNCHERS)
    rec_k, qbuf = dv._enc_group_kernels(*truth, fpd.CUDA_LAUNCHERS)
    plain_q = []
    rec_p = dv._encode_plain(vals, plain_q.append)
    _same("raht_fp_group (encode loop)", rec_k, rec_p)
    host = np.concatenate(plain_q).astype(np.int64)
    if not np.array_equal(qbuf.cpu().numpy(), host):
        raise AssertionError("raht_fp_group's q rows differ from the plain "
                             "loop's")
    rows = torch.as_tensor(host, device=dev)
    cuts = dv.rows.slices()
    _same("raht_fp_group (decode loop)",
          dv._decode_kernels(rows, fpd.CUDA_LAUNCHERS),
          dv._decode_plain(rows, [c.stop - c.start for c in cuts]))
    out["truth_levels_ms"] = _graph_ms(
        lambda: dv._truth_kernels(vals, fpd.CUDA_LAUNCHERS), reps)
    out["groups_encode_ms"] = _graph_ms(
        lambda: dv._enc_group_kernels(*truth, fpd.CUDA_LAUNCHERS), reps)
    out["groups_decode_ms"] = _graph_ms(
        lambda: dv._decode_kernels(rows, fpd.CUDA_LAUNCHERS), reps)
    out["groups_ms"] = out["groups_encode_ms"] + out["groups_decode_ms"]
    a, kw = largest_encode_group(dv, truth)
    out["largest_group_blocks"] = int(a[2])
    out["largest_group_ms"] = _graph_ms(lambda: fpd._cuda_group(*a, **kw),
                                        reps)
    if hasattr(fpd, "build_plan"):
        out.update(plan_times(uniq, depth, dev, reps))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
