"""The port's tracer (``mpeg_pcc_tmc13_tpu_torch.utils.timing``): off
unless a sink is installed, and then spans and counters at the stage
boundaries of the geometry pipeline and the RAHT planner, under the
caller's scope, on the profiler's timeline.  Tracing changes no byte of
a stream, no plan and no decoded code."""

import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mpeg_pcc_tmc13_tpu_torch.bitstream import entropy
from mpeg_pcc_tmc13_tpu_torch.models import geometry_octree as tgo
from mpeg_pcc_tmc13_tpu_torch.ops import octree as tops
from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as tfp
from mpeg_pcc_tmc13_tpu_torch.runtime import device_pipeline as tdp
from mpeg_pcc_tmc13_tpu_torch.utils import morton, timing
from pccbench.trace import Trace

torch.set_num_threads(2)

DEPTH = 7
STEPS = [1 << 16] * 3


def _codes(n=4000, extent=32, seed=3):
    """A dense block of a depth-7 cube: about 3,000 occupancy bytes, in
    the default budget of 2.3 a point and over a budget of 0.5."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, extent, (n, 3)).astype(np.int64)
    return tops.unique_sorted(np.sort(morton.encode(pos)))


def _encode(codes, **kw):
    enc = entropy.RangeEncoder()
    st = tdp.PipelineStats()
    tdp.encode_pipelined(codes, DEPTH, enc, tgo.OctreeContexts(), stats=st,
                         device="cpu", **kw)
    return enc.get_bytes(), st


def _decode(payload, num_slices, per):
    st = tdp.PipelineStats()
    outs = tdp.decode_pipelined(entropy.RangeDecoder(payload),
                                tgo.OctreeContexts(), DEPTH, num_slices, per,
                                stats=st, device="cpu")
    codes = np.concatenate([n[:int(c)].numpy() for n, c in outs])
    return codes, st


def _sink():
    return SimpleNamespace(spans={}, counters={})


def _no_ranges(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_off_by_default_records_nothing_and_opens_no_range(monkeypatch):
    _no_ranges(monkeypatch)
    assert timing._sink is None
    assert timing.span("a") is timing.span("b") is timing.counted("c")
    with timing.span("a"), timing.counted("c"):
        timing.count("d", 1.0)
    with timing.timed("e") as t:
        pass
    assert t.seconds >= 0.0
    assert timing._sink is None


def test_untraced_codec_opens_no_range(monkeypatch):
    """The stages of both sides run with tracing off and never reach the
    profiler."""
    _no_ranges(monkeypatch)
    codes = _codes()
    payload, st = _encode(codes, num_slices=2, cap_factor=0.5)
    got, _ = _decode(payload, 2, -(-codes.size // 2))
    assert np.array_equal(got, codes) and st.host_entropy_s > 0
    tfp.DeviceFpRaht(codes, DEPTH, STEPS, device="cpu")


@pytest.mark.parametrize("scope", ["", "encode", "decode"])
def test_sink_and_scope_name_nested_spans_and_sum_counters(scope):
    sink = _sink()
    pre = f"{scope}." if scope else ""
    with timing.tracing(sink, scope):
        with timing.span("outer"):
            with timing.span("inner"):
                timing.count("n", 2.0)
            timing.count("n", 3.0)
        with timing.span("inner"):
            pass
        with timing.counted("loop_s"):
            pass
    assert set(sink.spans) == {pre + "outer", pre + "inner"}
    assert sink.spans[pre + "outer"] >= 0.0
    assert sink.counters[pre + "n"] == 5.0
    assert sink.counters[pre + "loop_s"] >= 0.0
    assert timing._sink is None and timing._prefix == ""


def test_previous_sink_and_scope_return_after_an_exception():
    outer, inner = _sink(), _sink()
    with timing.tracing(outer, "encode"):
        with pytest.raises(ValueError):
            with timing.tracing(inner, "decode"):
                with timing.span("s"):
                    raise ValueError("inside")
        with timing.span("t"):
            pass
    assert set(inner.spans) == {"decode.s"}
    assert set(outer.spans) == {"encode.t"}
    assert timing._sink is None and timing._prefix == ""


@pytest.mark.parametrize("num_slices", [1, 3])
@pytest.mark.parametrize("cap_factor", [2.3, 0.5])
def test_geometry_stages_traced(num_slices, cap_factor):
    """``geom.redo`` only where the budget overflows; the entropy span and
    ``host_entropy_s`` are one reading; several slices fetch on the
    prefetch thread into the same sink."""
    codes = _codes()
    sink = _sink()
    with timing.tracing(sink, "encode"):
        payload, st = _encode(codes, num_slices=num_slices,
                              cap_factor=cap_factor)
    names = {"encode.geom.fetch", "encode.geom.entropy"}
    if cap_factor < 1:
        names.add("encode.geom.redo")
    assert set(sink.spans) == names and not sink.counters
    assert sink.spans["encode.geom.entropy"] == st.host_entropy_s
    with timing.tracing(sink, "decode"):
        got, sd = _decode(payload, num_slices, -(-codes.size // num_slices))
    assert np.array_equal(got, codes)
    assert set(sink.spans) == names | {"decode.geom.entropy",
                                       "decode.geom.count"}
    assert sink.spans["decode.geom.entropy"] == sd.host_entropy_s


def test_planner_traced():
    codes = _codes()
    sink = _sink()
    with timing.tracing(sink, "decode"):
        tfp.DeviceFpRaht(codes, DEPTH, STEPS, device="cpu")
    assert set(sink.spans) == {"decode.raht.plan.build",
                               "decode.raht.plan.upload"}
    assert set(sink.counters) == {"decode.raht.plan.search_s"}
    assert 0 < sink.counters["decode.raht.plan.search_s"] \
        <= sink.spans["decode.raht.plan.build"]


@pytest.mark.cuda
def test_card_planner_traced():
    """On a card the plan is built there: the same two spans, a count of
    the levels built on the card, and no host search."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the planner's kernels have no CPU "
                    "form")
    codes = _codes()
    sink = _sink()
    with timing.tracing(sink, "encode"):
        tfp.DeviceFpRaht(codes, DEPTH, STEPS, device="cuda")
    assert set(sink.spans) == {"encode.raht.plan.build",
                               "encode.raht.plan.upload"}
    assert sink.counters == {"encode.raht.plan.device_levels": DEPTH}


def _whole_frame(codes, vals):
    payload, _ = _encode(codes, num_slices=2, cap_factor=0.5)
    got, _ = _decode(payload, 2, -(-codes.size // 2))
    dv = tfp.DeviceFpRaht(codes, DEPTH, STEPS, device="cpu")
    qs = []
    recon = dv.encode(vals, qs.append)
    return payload, got, dv.plans, qs, recon


def test_tracing_changes_no_output():
    codes = _codes()
    vals = (np.arange(codes.size * 3).reshape(-1, 3) * 37) % 256
    off = _whole_frame(codes, vals)
    sink = _sink()
    with timing.tracing(sink, "encode"):
        on = _whole_frame(codes, vals)
    assert sink.spans
    assert on[0] == off[0]
    assert np.array_equal(on[1], off[1])
    for a, b in zip(on[2], off[2]):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(np.array_equal(a, b) for a, b in zip(on[3], off[3]))
    assert torch.equal(on[4], off[4])


def test_scoped_ranges_reach_the_profiler_trace(tmp_path):
    """Under ``torch.profiler`` the spans are ``user_annotation`` ranges
    that the benchmark's trace reader keeps by name."""
    codes = _codes(1500)
    sink = _sink()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timing.tracing(sink, "encode"):
            payload, _ = _encode(codes, num_slices=1, cap_factor=0.5)
            tfp.DeviceFpRaht(codes, DEPTH, STEPS, device="cpu")
        with timing.tracing(sink, "decode"):
            _decode(payload, 1, codes.size)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = set(sink.spans)
    assert names == {"encode.geom.fetch", "encode.geom.redo",
                     "encode.geom.entropy", "encode.raht.plan.build",
                     "encode.raht.plan.upload", "decode.geom.entropy",
                     "decode.geom.count"}
    trace = Trace.from_chrome(path, names | {"encode.raht.plan.search_s"})
    assert sorted(n for n, _, _ in trace.spans) == sorted(names)


def test_importing_the_tracer_loads_no_profiler():
    """The tracer reaches the profiler only when a span opens: importing
    it loads neither torch nor anything of the profiler."""
    code = ("import sys, json; "
            "import mpeg_pcc_tmc13_tpu_torch.utils.timing; "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert not [m for m in loaded if m == "torch" or "profiler" in m]
