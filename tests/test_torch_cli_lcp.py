"""``tmc3-cuda``'s default colour path, the float RAHT with last-component
prediction (LCP), held to the benchmark's plain reference; and the CLI
path's tracer.

The frames are small seeded height-field surfaces (2,016 points, a
depth-7 tree) with correlated RGB, coded with the options of the
benchmark configuration ``pccbench/configs/vox10_body_cli.json`` (the
CTC octree-raht r04 ``encoder.cfg``, LCP at the CLI's default) and
``--device=cpu``, through the benchmark's own codec
(``pccbench/codecs/tmc3_cli.py``: ``FrameEncoder`` and ``FrameDecoder``).
The decoded RGB and the signalled LCP coefficients must meet the limits
of the benchmark's check (``pccbench/checks/tmc3_colour.py``) against
``pccbench/reference/raht_lcp.py``, each loaded by file."""

import importlib.util
import json
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mpeg_pcc_tmc13_tpu_torch.runtime import cli
from mpeg_pcc_tmc13_tpu_torch.utils import morton, ply, timing
from pccbench.spans import Clock
from pccbench.window import Mix

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "pccbench/configs/vox10_body_cli.json").read_text())
SPANS = {"encode.frame.prepare", "encode.geom.brick", "encode.attr.brick",
         "decode.geom.brick", "decode.attr.brick"}
COUNTERS = {f"{side}.attr.{name}" for side in ("encode", "decode")
            for name in ("entropy_s", "lcp_layers", "native_bricks")}


def _load(rel):
    spec = importlib.util.spec_from_file_location(
        "lcp_" + Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CODEC = _load("pccbench/codecs/tmc3_cli.py")
CHECK = _load("pccbench/checks/tmc3_colour.py")


def _frame(seed):
    """A height field over 96 x 21 cells (x reaches 95: depth 7) with a
    smooth colour field whose channels move together, plus noise."""
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.arange(96), np.arange(21), indexing="ij")
    z = np.round(20 + 8 * np.sin(x / 9 + rng.uniform(0, 6))
                 * np.cos(y / 5)).astype(np.int64)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.int64)
    field = (np.sin(pos[:, 0] / 7 + rng.uniform(0, 6))
             + np.cos(pos[:, 1] / 4))[:, None]
    rgb = (rng.integers(60, 190, 3) + 40 * field * np.array([1, .6, -.5])
           + rng.normal(0, 3, (pos.shape[0], 3)))
    codes = morton.encode(pos)
    order = np.argsort(codes)
    return SimpleNamespace(
        codes=codes[order],
        values=np.clip(np.round(rgb), 0, 255).astype(np.int64)[order])


def _codec(cfg=CFG):
    return CODEC.make(cfg, Mix.from_data({"attributes": True}),
                      [torch.device("cpu")], Clock(False))


def _lcp_off():
    opts = [o for o in CFG["cli_options"] if o != "--attribute=color"]
    return {**CFG, "cli_options": opts + [
        "--lastComponentPredictionEnabled=0", "--attribute=color"]}


def _sink():
    return SimpleNamespace(spans={}, counters={})


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 2**40 + 5])
def test_cli_colour_matches_the_plain_reference(seed):
    fr = _frame(seed)
    codec = _codec()
    e = codec.encode(fr.codes, fr.values)
    codes, values = codec.decode(e.geom, e.attr, fr.codes.size)
    np.testing.assert_array_equal(codes, fr.codes)
    ref = CHECK.reference(fr, CFG)
    got = CHECK.numbers([CHECK.outputs(e, values)], ref)
    assert got == {k: 0 for k in CHECK.LIMITS}
    assert len(ref["lcp"]) == 1 + 3 * 7
    # the reference with LCP off is another coding
    off = CHECK.numbers([CHECK.controls(fr, CFG)["control_lcp_off"]], ref)
    assert off["attr_decoded_wrong"] > 0 and off["attr_lcp_coeff_wrong"] > 0


def test_stream_decodes_through_the_cli(tmp_path):
    """The codec's units, written as one file, are a stream that
    ``tmc3-cuda --mode=1`` decodes to the codec's own cloud."""
    fr = _frame(7)
    codec = _codec()
    e = codec.encode(fr.codes, fr.values)
    codes, values = codec.decode(e.geom, e.attr, fr.codes.size)
    stream, rec = tmp_path / "f.bin", tmp_path / "rec_%04d.ply"
    stream.write_bytes(e.geom + e.attr)
    assert cli.main(["--mode=1", f"--compressedStreamPath={stream}",
                     f"--reconstructedDataPath={rec}", "--device=cpu"]) == 0
    out = ply.read(str(ply.expand_num(str(rec), 0)))
    got = morton.encode(np.round(out.positions).astype(np.int64))
    order = np.argsort(got)
    np.testing.assert_array_equal(got[order], codes)
    np.testing.assert_array_equal(np.asarray(out.colors)[order], values)


@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_lcp_engages_and_changes_the_stream(seed):
    fr = _frame(seed)
    streams, layers, native = {}, {}, {}
    for name, cfg in (("on", CFG), ("off", _lcp_off())):
        sink = _sink()
        with timing.tracing(sink, "encode"):
            e = _codec(cfg).encode(fr.codes, fr.values)
        streams[name] = e.attr
        layers[name] = sink.counters["encode.attr.lcp_layers"]
        native[name] = sink.counters["encode.attr.native_bricks"]
    assert streams["on"] != streams["off"]
    # with LCP on the brick stays on the host numpy path
    assert native["on"] == 0
    assert layers["on"] > 0 and layers["off"] == 0


@pytest.mark.parametrize("traced", [False, True])
def test_cli_stages_traced_only_under_a_sink(monkeypatch, traced):
    fr = _frame(9)
    plain = _codec()
    e0 = plain.encode(fr.codes, fr.values)
    dec0 = plain.decode(e0.geom, e0.attr, fr.codes.size)
    sink = _sink()
    if not traced:
        def refuse(*a, **k):
            raise AssertionError("a profiler range was opened")
        monkeypatch.setattr(torch.profiler, "record_function", refuse)
    codec = _codec()
    with timing.tracing(sink, "encode") if traced else nullcontext():
        e = codec.encode(fr.codes, fr.values)
    with timing.tracing(sink, "decode") if traced else nullcontext():
        dec = codec.decode(e.geom, e.attr, fr.codes.size)
    assert timing._sink is None
    # tracing changes no byte and no decoded value
    assert (e.geom, e.attr) == (e0.geom, e0.attr)
    for a, b in zip(dec, dec0):
        np.testing.assert_array_equal(a, b)
    if traced:
        assert SPANS <= set(sink.spans) and COUNTERS <= set(sink.counters)
        assert all(sink.spans[s] > 0 for s in SPANS)
        assert sink.counters["encode.attr.entropy_s"] > 0
        assert sink.counters["decode.attr.lcp_layers"] \
            == sink.counters["encode.attr.lcp_layers"] > 0
    else:
        assert sink.spans == {} and sink.counters == {}
