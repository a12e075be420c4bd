"""The metric arithmetic: rates over summed walls, the tail over every
frame, per-frame layer times, the idle share, the rooflines and the
breakdown from a synthetic trace, and the last-line format."""

import json

import numpy as np
import pytest

from pccbench import sets
from pccbench.frames import Frame, tree_work
from pccbench.roofline import octree_expand, raht_fp_group
from pccbench.spans import Record
from pccbench.stats import Run, p95, rate_mpts
from pccbench.trace import Trace, union

KIND = "NVIDIA H100 80GB HBM3"


def _records():
    recs = []
    for i, (enc, dec) in enumerate([(0.1, 0.3), (0.2, 0.3), (0.7, 0.4)]):
        r = Record(frame=i % 2, points=1_000_000 * (i + 1))
        r.spans = {"encode": enc, "decode": dec, "encode.geom": enc / 2}
        r.counters = {"encode.geom_entropy": 0.01, "encode.emit": 0.02}
        r.payload_bytes = 1000
        recs.append(r)
    return recs


def _run(trace=None):
    codes = np.array([0, 1, 9, 64, 65, 511], dtype=np.int64)
    fr = Frame(codes, np.zeros((6, 3), np.int64), tree_work(codes, 3))
    return Run(_records(), [fr, fr], 5.0, 3, KIND, trace)


def test_rate_is_points_over_summed_walls():
    # not the mean of per-frame rates: 6M points over 1.0 s
    assert rate_mpts([1e6, 2e6, 3e6], [0.1, 0.2, 0.7]) == pytest.approx(6.0)
    assert _run().side_rate("encode") == pytest.approx(6.0)
    assert _run().side_rate("decode") == pytest.approx(6.0)
    assert rate_mpts([1], [0.0]) is None


def test_p95_over_every_frame():
    vals = list(range(1, 101))
    assert p95(vals) == pytest.approx(np.percentile(vals, 95))
    assert p95([]) is None


def test_per_frame_layer_times():
    run = _run()
    assert run.per_frame_ms(run.span_total("encode.geom")) == \
        pytest.approx(1e3 * 0.5 / 3)
    assert run.span_total("decode.attr_plan") is None
    assert run.counter_total("encode.emit") == pytest.approx(0.06)


def test_tree_work_counts_levels():
    w = tree_work(np.array([0, 1, 9, 64, 65, 511], np.int64), 3)
    assert w["nodes"] == [6, 4, 3, 1]
    assert w["occupancy_bytes"] == 8
    assert octree_expand.bytes_moved(w, 3, "decode") == 8 + 12 + 48
    enc = raht_fp_group.bytes_moved(w, 3, "encode")
    dec = raht_fp_group.bytes_moved(w, 3, "decode")
    assert enc > dec > 0


def _trace():
    # one frame: encode 0-10 s, decode 10-20 s; a group kernel of 1 s in
    # each side, an expansion of 2 s in the decode, a copy of 1 s
    ops = [("raht_fp_group_kernel", 1.0, 2.0), ("memcpy HtoD", 4.0, 5.0),
           ("raht_fp_group_kernel", 11.0, 12.0),
           ("octree_expand_level_kernel", 12.5, 14.5)]
    spans = [("window", 0.0, 20.0), ("encode", 0.0, 10.0),
             ("encode.attr_plan", 2.0, 9.0), ("decode", 10.0, 20.0),
             ("decode.geom", 10.0, 15.0)]
    return Trace(ops, spans)


def test_idle_share_from_trace():
    tr = _trace()
    assert tr.busy("encode") == (pytest.approx(2.0), pytest.approx(10.0))
    run = _run(tr)
    assert run.idle_percent("encode") == pytest.approx(80.0)
    assert run.idle_percent("decode") == pytest.approx(70.0)
    assert tr.busy("window") == (pytest.approx(5.0), pytest.approx(20.0))


def test_roofline_from_trace():
    tr = _trace()
    assert tr.op_time(raht_fp_group.KERNELS, "encode") == pytest.approx(1.0)
    assert tr.op_time(octree_expand.KERNELS, "decode") == pytest.approx(2.0)
    run = _run(tr)
    w = run.frames[0].work
    moved = 3 * octree_expand.bytes_moved(w, 3, "decode")
    assert run.roofline(octree_expand, "decode") == pytest.approx(
        100 * moved / 3.35e12 / 2.0)
    assert run.roofline(octree_expand, "encode") is None   # no launch
    assert _run(None).roofline(octree_expand, "decode") is None
    other = Run(_records(), run.frames, 1, 3, "unknown card", tr)
    assert other.roofline(octree_expand, "decode") is None


def test_breakdown_lists():
    tr = _trace()
    ops = dict(tr.device_ops())
    assert ops["raht_fp_group_kernel"] == pytest.approx(2.0)
    gaps = dict(tr.idle_gaps())
    # idle 0-1, 2-4, 5-11, 12-12.5, 14.5-20, split by the innermost
    # span open: encode 0-2 and 9-10, its plan 2-9, decode.geom 10-15,
    # decode 15-20
    assert sum(gaps.values()) == pytest.approx(15.0)
    assert gaps == {"encode": pytest.approx(1.0 + 1.0),
                    "encode.attr_plan": pytest.approx(2.0 + 4.0),
                    "decode.geom": pytest.approx(1.0 + 0.5 + 0.5),
                    "decode": pytest.approx(5.0)}
    assert len(tr.device_ops(top=1)) == 1


def test_union():
    assert union([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]


def test_spread_is_quartiles_over_median():
    med, sp = sets.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    assert med == 3.5
    q1, _, q3 = __import__("statistics").quantiles(
        [1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert sp == pytest.approx((q3 - q1) / 3.5)


def test_chrome_trace_parsing(tmp_path):
    events = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void raht_fp_group_kernel("
         "GroupArgs)", "ts": 1_000_000, "dur": 1_000_000},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::"
         "octree_expand_level_kernel(XStream, XScratch, long long, int)",
         "ts": 2_000_000, "dur": 500_000},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 3_000_000, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "encode",
         "ts": 0, "dur": 5_000_000},
        {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 0,
         "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 1}]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(events))
    tr = Trace.from_chrome(path, ("encode",))
    assert [o[0] for o in tr.ops] == ["raht_fp_group_kernel",
                                      "octree_expand_level_kernel",
                                      "Memcpy HtoD"]
    assert tr.spans == [("encode", 0.0, 5.0)]
    assert tr.op_time(raht_fp_group.KERNELS, "encode") == pytest.approx(1.0)
    assert tr.op_time(octree_expand.KERNELS, "encode") == pytest.approx(0.5)
