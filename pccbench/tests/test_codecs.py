"""Codecs and checks found by name: a configuration that names its own
codec, check and chips runs with files added alone; the default codec is
the port's direct calls, byte for byte, and installs the port's tracer in
traced runs only; the devices a cell's ``chips`` asks for."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pccbench import codec as codec_api, run, spec
from pccbench.codecs import octree_raht_fp
from pccbench.frames import make_frames, step_q16
from pccbench.spans import Clock, Record
from pccbench.tests.conftest import ROOT
from pccbench.window import Mix

from mpeg_pcc_tmc13_tpu_torch.bitstream import entropy
from mpeg_pcc_tmc13_tpu_torch.models.attributes import AttributeContexts
from mpeg_pcc_tmc13_tpu_torch.models.geometry_octree import OctreeContexts
from mpeg_pcc_tmc13_tpu_torch.ops.raht_fp_device import DeviceFpRaht
from mpeg_pcc_tmc13_tpu_torch.runtime import device_pipeline as dp
from mpeg_pcc_tmc13_tpu_torch.utils import timing

SEED = 2**31 + 19

PROBE_CODEC = '''"""A test's codec: the default codec, with a span of its own and a
count of the devices it was handed."""
import time

from pccbench.codecs import octree_raht_fp

SPAN_NAMES = octree_raht_fp.SPAN_NAMES + ("encode.probe",)


def make(cfg, mix, devices, clock):
    return Probe(octree_raht_fp.make(cfg, mix, devices[:1], clock),
                 devices, clock)


class Probe:
    def __init__(self, inner, devices, clock):
        self.inner, self.devices, self.clock = inner, list(devices), clock

    def encode(self, codes, values):
        with self.clock.span("encode.probe"):
            time.sleep(0.02)
            if self.clock.record is not None:
                self.clock.record.add("probe.devices", len(self.devices))
        return self.inner.encode(codes, values)

    def decode(self, geom, attr, points):
        return self.inner.decode(geom, attr, points)
'''

PROBE_CHECK = '''"""A test's check: the decoded values' shape against the frame's."""
LIMITS = {"probe_shape_wrong": 0}
FAULT = %d


def outputs(e, values):
    return {"shape": None if values is None else tuple(values.shape)}


def reference(frame, cfg):
    return tuple(frame.values.shape)


def controls(frame, cfg):
    return {"control_no_values": {"shape": None}}


def numbers(kept, ref):
    return {"probe_shape_wrong": FAULT + sum(k["shape"] != ref
                                             for k in kept)}
'''

PROBE_GEN = '''"""A test's generator: scattered voxels with random values."""
import numpy as np


def make(cfg, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(cfg["frames"])):
        codes = np.unique(rng.integers(0, 1 << (3 * cfg["bits"]),
                                       cfg["points"]))
        out.append((codes, rng.integers(0, 256,
                                        (codes.size, cfg["channels"]))))
    return out
'''

READERS = {
    "probe_ms": "def read(run):\n"
                "    return run.per_frame_ms(run.span_total('encode.probe'))\n",
    "probe_devices": "def read(run):\n"
                     "    return run.counter_total('probe.devices') / "
                     "len(run.records)\n",
}


def _add(root, cfg, chips=1, fault=0):
    """A configuration named ``probe``, its codec, check and readers,
    and one cell ``probe.intra_raht``, by files and entries alone."""
    pcc = root / "pccbench"
    (pcc / "codecs" / "probe.py").write_text(PROBE_CODEC)
    (pcc / "checks" / "probe_shape.py").write_text(PROBE_CHECK % fault)
    for name, src in READERS.items():
        (pcc / "metrics" / f"{name}.py").write_text(src)
    (pcc / "configs" / "probe.json").write_text(json.dumps(
        {**cfg, "codec": "probe", "check": "probe_shape"}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    name = "probe.intra_raht"
    bench["configs"].append({"name": "probe", "source": "a test",
                             "file": "pccbench/configs/probe.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": name, "config": "probe",
                               "traffic": "intra_raht", "chips": chips,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("encode_mpts", "decode_mpts"):
            m["workloads"].append(name)
    for reader in READERS:
        bench["per_layer"].append({
            "name": reader, "unit": "1", "better": "lower",
            "source": "program_span", "layer": "test",
            "moves": "encode_mpts", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return name


def _body(root):
    cfg = json.loads(
        (root / "pccbench/configs/vox10_body.json").read_text())
    return {**cfg, "frames": 1}


def _run(root, name, traced=True, seconds=0.4):
    return run.run_cell(spec.load_cell(name, root=root), SEED, seconds,
                        traced, "cpu")


def test_codec_named_by_the_configuration(tiny_root):
    """Its span reaches the frame's record and the traced span set."""
    name = _add(tiny_root, _body(tiny_root))
    cell = spec.load_cell(name, root=tiny_root)
    assert "encode.probe" in run.span_names(cell.codec())
    res = _run(tiny_root, name)
    assert res["correct"] and res["failed"] == 0
    assert res["metrics"]["probe_ms"]["value"] >= 20.0
    assert "encode.probe" in dict(res["breakdown"]["idle_gaps"])
    assert "encode.geom" in run.span_names(cell.codec())
    assert "attr_q_wrong" not in res["checks"]


@pytest.mark.parametrize("fault", [0, 1])
def test_check_named_by_the_configuration(tiny_root, fault):
    name = _add(tiny_root, _body(tiny_root), fault=fault)
    res = _run(tiny_root, name, traced=False)
    assert res["checks"] == {
        "geom_codes_wrong": {"value": 0, "limit": 0},
        "probe_shape_wrong": {"value": fault, "limit": 0}}
    assert res["correct"] is (fault == 0)
    assert (res["failed"] >= 1) is bool(fault)


def test_two_chips_hand_the_codec_two_devices(tiny_root):
    name = _add(tiny_root, _body(tiny_root), chips=2)
    res = _run(tiny_root, name)
    assert res["correct"]
    assert res["device"]["count"] == 2
    assert res["metrics"]["probe_devices"]["value"] == 2
    assert run.cell_devices("cpu", 2) == [torch.device("cpu")] * 2
    assert run.cell_devices("cuda", 2) == [torch.device("cuda", 0),
                                           torch.device("cuda", 1)]


def test_the_fullest_device_is_reported(monkeypatch):
    peaks = {0: 5_000, 1: 9_000, 2: 7_000}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: peaks[torch.device(d).index])
    desc = codec_api.device_description(run.cell_devices("cuda", 3))
    assert desc == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                    "count": 3, "memory_peak_bytes": 9_000}
    assert codec_api.device_description(
        run.cell_devices("cuda", 1))["memory_peak_bytes"] == 5_000


def test_everything_added_by_files_alone(tiny_root):
    """A generator, a configuration, a codec, a check and a two-chip cell
    added as files, in a process whose ``pccbench`` is the tiny root's:
    the run is correct, and a fault in the check's numbers is not."""
    name = _add(tiny_root, {"generator": "probe_cubes", "bits": 6,
                            "points": 3000, "channels": 3, "qp": 34,
                            "slices": 1, "frames": 2}, chips=2)
    (tiny_root / "pccbench/gen/probe_cubes.py").write_text(PROBE_GEN)
    code = ("import json, torch; torch.set_num_threads(2); "
            "from pccbench import run, spec; "
            f"print(json.dumps(run.run_cell(spec.load_cell({name!r}), "
            f"{SEED}, 0.4, True, 'cpu')))")
    env = {**os.environ, "PYTHONPATH": f"{tiny_root}{os.pathsep}{ROOT}"}

    def result():
        proc = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                              capture_output=True, text=True, timeout=300,
                              env=env)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return json.loads(proc.stdout.strip().splitlines()[-1])

    res = result()
    assert res["correct"] and res["device"]["count"] == 2
    assert res["metrics"]["probe_devices"]["value"] == 2
    assert set(res["checks"]) == {"geom_codes_wrong", "probe_shape_wrong"}
    (tiny_root / "pccbench/checks/probe_shape.py").write_text(PROBE_CHECK % 1)
    res = result()
    assert res["correct"] is False
    assert res["checks"]["probe_shape_wrong"]["value"] == 1


def _frame(root, config):
    cfg = json.loads((root / f"pccbench/configs/{config}.json").read_text())
    return cfg, make_frames(cfg, SEED, channels=int(cfg["channels"]))[0]


def test_default_codec_is_the_ports_direct_calls(tiny_root):
    """The bytes, reconstruction and decoded values of the default codec
    equal those of the port's calls made directly, traced or not."""
    cfg, fr = _frame(tiny_root, "vox10_body")
    depth, nc = int(cfg["bits"]), int(cfg["channels"])
    steps = [step_q16(int(cfg["qp"]))] * nc

    enc = entropy.RangeEncoder()
    dp.encode_pipelined(fr.codes, depth, enc, OctreeContexts(),
                        num_slices=1, packed_link=False,
                        device_codes=[torch.as_tensor(fr.codes)],
                        stats=dp.PipelineStats())
    geom = enc.get_bytes()
    aenc, actx = entropy.RangeEncoder(), AttributeContexts()
    recon = DeviceFpRaht(fr.codes, depth, steps, device="cpu").encode(
        fr.values,
        lambda q: aenc.zrow_residuals(actx.zrow, q.astype(np.int32)))
    attr = aenc.get_bytes()
    adec, dctx = entropy.RangeDecoder(attr), AttributeContexts()
    values = DeviceFpRaht(fr.codes, depth, steps, device="cpu").decode(
        lambda m: adec.zrow_residuals(dctx.zrow, m, nc), nc).numpy()

    mix = Mix.from_data({"attributes": True})
    for traced in (False, True):
        clock = Clock(traced)
        codec = octree_raht_fp.make(cfg, mix, ["cpu"], clock)
        clock.record = Record(frame=0, points=fr.points)
        e = codec.encode(fr.codes, fr.values)
        assert e.geom == geom and e.attr == attr
        np.testing.assert_array_equal(e.recon.numpy(), recon.numpy())
        codes, vals = codec.decode(e.geom, e.attr, fr.points)
        np.testing.assert_array_equal(codes, fr.codes)
        np.testing.assert_array_equal(vals, values)


@pytest.mark.parametrize("traced", [False, True])
def test_the_ports_tracer_only_in_traced_runs(tiny_root, traced):
    cfg, fr = _frame(tiny_root, "lidar_hdl64")
    clock = Clock(traced)
    codec = octree_raht_fp.make(cfg, Mix.from_data({"attributes": False}),
                                ["cpu"], clock)
    clock.record = rec = Record(frame=0, points=fr.points)
    e = codec.encode(fr.codes, fr.values)
    codec.decode(e.geom, e.attr, fr.points)
    assert timing._sink is None
    stages = set(octree_raht_fp.PROGRAM_STAGES)
    if traced:
        # the tiny LiDAR frame's bytes overflow the raw link's budget
        assert stages <= set(rec.spans)
        assert rec.spans["decode.geom.count"] > 0
    else:
        assert not stages & set(rec.spans)
    assert {"encode", "decode", "encode.geom", "decode.geom"} <= set(rec.spans)


@pytest.mark.parametrize("cell", ["lidar_hdl64.geom_only",
                                  "vox10_body.geom_only"])
def test_traced_run_reads_the_program_stages(tiny_root, cell):
    res = _run(tiny_root, cell)
    m = res["metrics"]
    assert m["geom_count_ms.geom_only"]["value"] > 0
    assert m["geom_fetch_ms.geom_only"]["value"] > 0
    assert ("geom_redo_ms.geom_only" in m) == cell.startswith("lidar")
    if cell.startswith("lidar"):
        assert m["geom_redo_ms.geom_only"]["value"] > 0
    assert "decode.geom.count" in run.span_names(
        spec.load_cell(cell, root=tiny_root).codec())
    res = _run(tiny_root, cell, traced=False)
    assert not any(k.startswith("geom_count") for k in res["metrics"])


def test_the_default_codec_refuses_slices_it_ignores(tiny_root):
    path = tiny_root / "pccbench/configs/vox10_body.json"
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                "slices": 2}))
    with pytest.raises(ValueError, match="slices"):
        _run(tiny_root, "vox10_body.intra_raht", traced=False)

