"""One run of one benchmark cell of the PyTorch + CUDA port.

    python3 -m pccbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Set-up makes the cell's frames from the seed, loads the codec that
the configuration names (``codecs/<codec>.py``, which loads the port:
its CUDA kernels and native library, built into ``build/`` of the
checkout by the first run there) on the cell's ``chips`` devices, and
codes the largest frame once, untimed; it prints its phases on standard
error.  The window codes frames one at a time, cycling through them, as
the cell's traffic mix says (``window.py``): the encode side, then the
decode side of its streams.  After the window, the outputs are judged
against the plain reference: the geometry by ``check.py``, the
attributes by the configuration's check (``checks/<check>.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (frames coded in the window), ``failed`` (frames whose
judged output was wrong), ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics, each from its reader in
``metrics/``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit; the same numbers
are the last lines of standard error.  Without a CUDA device, with
fewer than the cell's chips, or with ``jax`` or the JAX package loaded
once the window has closed, the run prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from contextlib import nullcontext
from pathlib import Path

T_START = time.perf_counter()

from . import check, spec  # noqa: E402
from .codec import device_description  # noqa: E402
from .frames import make_frames  # noqa: E402
from .spans import Clock  # noqa: E402
from .stats import Run  # noqa: E402
from .trace import Trace  # noqa: E402
from .window import Window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mpeg_pcc_tmc13_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``mpeg_pcc_tmc13_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fix_cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / "build" / "pccbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def _profiler(traced: bool, cuda: bool):
    if not traced:
        return nullcontext()
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


# the window's and the sides' spans; a codec adds its own
BASE_SPANS = ("window", "encode", "decode")


def span_names(codec_module) -> tuple:
    """The spans a traced run keeps on the device's timeline."""
    return BASE_SPANS + tuple(getattr(codec_module, "SPAN_NAMES", ()))


def cell_devices(backend: str, chips: int) -> list:
    """``chips`` devices: ``cuda:0`` ... ``cuda:{chips-1}``, or as many
    host entries on the CPU."""
    import torch
    if backend == "cuda":
        return [torch.device("cuda", i) for i in range(chips)]
    return [torch.device(backend)] * chips


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             backend: str, t_start: float = T_START) -> dict:
    """The result line of one run of ``cell`` on ``backend``'s devices
    (``"cuda"``, or ``"cpu"`` for the tests)."""
    import torch

    cfg, mix = cell.config, cell.mix
    nc = int(cfg["channels"])
    devices = cell_devices(backend, cell.chips)
    cuda = devices[0].type == "cuda"

    phases = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    frames = make_frames(cfg, seed, channels=nc, with_work=traced)
    phases["frames"] = time.perf_counter() - t
    t = time.perf_counter()
    clock = Clock(traced)
    codec_module, chk = cell.codec(), cell.check()
    codec = codec_module.make(cfg, mix, devices, clock)
    phases["port"] = time.perf_counter() - t
    sample = check.sample_frame(seed, len(frames))
    window = Window(codec, frames, mix, clock, sample, chk.outputs)
    t = time.perf_counter()
    window.warm()
    phases["warm"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f" total {setup_s:.3f} s", file=sys.stderr, flush=True)

    prof = _profiler(traced, cuda)
    with prof:
        records, kept = window.run(seconds)
    if mix.attributes and not kept:
        kept.append(window.judge_late())
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded after the window: {', '.join(found)}")

    desc = device_description(devices)
    trace = None
    if traced:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            trace = Trace.from_chrome(path, span_names(codec_module))
        del prof
        busy_s, win_s = trace.busy("window")
        desc["busy_s"] = busy_s
        desc["window_s"] = win_s
    del codec, window
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    run = Run(records, frames, setup_s, nc, desc["kind"], trace)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = cell.reader(m.name)(run)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}

    # correctness, once the window has closed and the program is freed
    numbers = {"geom_codes_wrong": sum(r.geom_wrong for r in records)}
    limits = dict(check.LIMITS)
    failed = {i for i, r in enumerate(records) if r.geom_wrong}
    if mix.attributes:
        fr = frames[sample]
        ref = chk.reference(fr, cfg)
        codings = [i for i, r in enumerate(records) if r.frame == sample]
        for i, out in zip(codings, kept):
            if not check.passes(chk.numbers([out], ref), chk.LIMITS):
                failed.add(i)
        numbers.update(chk.numbers(kept, ref))
        limits.update(chk.LIMITS)
    correct = bool(records) and check.passes(numbers, limits)

    result = {"correct": correct, "attempted": len(records),
              "failed": len(failed), "metrics": metrics, "device": desc}
    if traced:
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps("window")}
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    fix_cache_dirs(spec.ROOT)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda")
    found = forbidden_modules()
    if found:
        print(f"loaded: {', '.join(found)}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
