"""Whole runs on the CPU at a tiny size (the port's plain versions stand
in for its kernels): the result line, a cell and a metric added by files
alone, the faults that must make ``correct`` false, the controls, and
the refusals (no card, no port, JAX loaded)."""

import json
import subprocess
import sys

import pytest

from pccbench import check, control, run, spec
from pccbench.tests.conftest import ROOT

from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
from mpeg_pcc_tmc13_tpu_torch.runtime import device_pipeline as dp

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 7


def _run(root, cell, traced=False, seconds=0.3, seed=SEED):
    return run.run_cell(spec.load_cell(cell, root=root), seed, seconds,
                        traced, "cpu")


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tiny_root, cell, traced):
    res = _run(tiny_root, cell, traced)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["device"]["count"] == 1
    for v in res["checks"].values():
        assert v["value"] <= v["limit"]
    c = spec.load_cell(cell, root=tiny_root)
    wanted = c.per_layer if traced else c.end_to_end
    names = {m.name for m in wanted}
    assert set(res["metrics"]) <= names
    if traced:
        # no device on the CPU: every trace reader finds nothing
        assert not any(m.source == "device_trace" for m in wanted
                       if m.name in res["metrics"])
        assert "breakdown" in res and "window_s" in res["device"]
    else:
        assert set(res["metrics"]) == names
        assert res["metrics"]["setup_s"]["unit"] == "s"
    json.dumps(res)


# mixes whose loops differ, each added as a data file alone
MIXES = {
    "closed_colour": {"attributes": True},
    "player": {"attributes": True, "sides": ["decode"]},
    "open_20hz": {"attributes": False, "arrival_hz": 20},
}
LATENCY_READER = """def read(run):
    return 1e3 * max(r.done_s - r.arrival_s for r in run.records)
"""


def _add_cell(root, mix, params):
    """A configuration, a traffic mix, a cell and two metric readers,
    added by files and entries alone."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "pccbench/configs/vox10_body.json").read_text())
    cfg["frames"] = 1
    (root / "pccbench/configs/dummy_body.json").write_text(json.dumps(cfg))
    (root / f"pccbench/traffic/{mix}.json").write_text(json.dumps(params))
    (root / "pccbench/metrics/frames_coded.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    (root / "pccbench/metrics/latency_ms_max.py").write_text(LATENCY_READER)
    name = f"dummy_body.{mix}"
    bench["configs"].append({"name": "dummy_body", "source": "a test",
                             "file": "pccbench/configs/dummy_body.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": name, "config": "dummy_body",
                               "traffic": mix, "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        # the rates list their cells: a new cell that reports them is
        # added to their lists
        if m["name"] in ("encode_mpts", "decode_mpts") and "workloads" in m:
            m["workloads"].append(name)
    bench["end_to_end"].append({"name": "latency_ms_max", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock", "workloads": [name]})
    bench["per_layer"].append({"name": "frames_coded", "unit": "frames",
                               "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "decode_mpts", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return name


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_cell_and_metric_added_by_files_alone(tiny_root, mix):
    name = _add_cell(tiny_root, mix, MIXES[mix])
    res = _run(tiny_root, name, traced=True, seconds=0.6)
    assert res["correct"] and res["failed"] == 0
    assert res["metrics"]["frames_coded"]["value"] == res["attempted"]
    assert "attr_plan_ms.encode" not in res["metrics"]  # not listed there
    res = _run(tiny_root, name, seconds=0.6)
    assert res["correct"]
    assert "frames_coded" not in res["metrics"]
    assert "decode_mpts" in res["metrics"]
    assert res["metrics"]["latency_ms_max"]["value"] > 0
    assert ("encode_mpts" in res["metrics"]) == (mix != "player")
    assert ("attr_decoded_gap" in res["checks"]) == MIXES[mix]["attributes"]


def test_open_loop_keeps_to_its_arrivals(tiny_root):
    """Frame k starts no sooner than k / rate, and every frame that
    arrives before the close is coded."""
    from pccbench.spans import Clock
    from pccbench.window import Mix, Window

    class Instant:
        def encode(self, codes, values):
            return type("E", (), {"geom": b"g", "attr": b"", "q_rows": [],
                                  "recon": None})()

        def decode(self, geom, attr, points):
            return frames[0].codes, None

    cell = spec.load_cell("lidar_hdl64.geom_only", root=tiny_root)
    from pccbench.frames import make_frames
    frames = make_frames(cell.config, 3, channels=1)[:1]
    mix = Mix.from_data({"attributes": False, "arrival_hz": 40})
    w = Window(Instant(), frames, mix, Clock(False), 0, None)
    records, _ = w.run(0.5)
    assert len(records) == 20
    for k, r in enumerate(records):
        assert r.arrival_s == pytest.approx(k / 40)
        assert r.start_s >= r.arrival_s and r.done_s >= r.start_s


@pytest.mark.parametrize("bad", [{"attributes": True, "loop": "closed"},
                                 {"attributes": True, "sides": ["encode"]},
                                 {"attributes": True, "arrival_hz": -1}])
def test_a_mix_the_loop_cannot_run_is_refused(bad):
    from pccbench.window import Mix
    with pytest.raises(ValueError):
        Mix.from_data(bad)


def _half_decode(mp):
    orig = dp.decode_pipelined

    def f(*a, **k):
        (nodes, cnt), = orig(*a, **k)
        return [(nodes, cnt // 2)]
    mp.setattr(dp, "decode_pipelined", f)


def _code_altered(mp):
    orig = dp.decode_pipelined

    def f(*a, **k):
        (nodes, cnt), = orig(*a, **k)
        nodes = nodes.clone()
        nodes[int(cnt) // 2] += 1
        return [(nodes, cnt)]
    mp.setattr(dp, "decode_pipelined", f)


def _q_altered(mp):
    orig = fpd.DeviceFpRaht.encode

    def f(self, values, emit):
        done = []

        def emit2(q):
            if not done:
                q = q.copy()
                q.flat[0] += 1
                done.append(1)
            emit(q)
        return orig(self, values, emit2)
    mp.setattr(fpd.DeviceFpRaht, "encode", f)


def _recon_altered(mp):
    orig = fpd.DeviceFpRaht.encode

    def f(self, values, emit):
        r = orig(self, values, emit).clone()
        r[r.shape[0] // 2, 0] += 1
        return r
    mp.setattr(fpd.DeviceFpRaht, "encode", f)


def _decode_unchanged(mp):
    """The decoder hands back its state of the call before."""
    orig = fpd.DeviceFpRaht.decode
    last = []

    def f(self, read_q, nc):
        out = orig(self, read_q, nc)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    mp.setattr(fpd.DeviceFpRaht, "decode", f)


FAULTS = {"half_of_the_frame_decoded": (_half_decode, "geom_codes_wrong"),
          "decoded_code_altered": (_code_altered, "geom_codes_wrong"),
          "q_row_altered": (_q_altered, "attr_q_wrong"),
          "reconstruction_altered": (_recon_altered, "attr_recon_gap"),
          "decoder_state_unchanged": (_decode_unchanged,
                                      "attr_decoded_gap")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_incorrect(tiny_root, monkeypatch, fault):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    res = _run(tiny_root, "vox10_body.intra_raht", seconds=0.5)
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


@pytest.mark.parametrize("fault", ["decoded_code_altered",
                                   "decoder_state_unchanged"])
def test_fault_makes_a_player_incorrect(tiny_root, monkeypatch, fault):
    """Where set-up makes the streams, the window's decodes are judged."""
    name = _add_cell(tiny_root, "player", MIXES["player"])
    cfg = tiny_root / "pccbench/configs/dummy_body.json"
    cfg.write_text(json.dumps({**json.loads(cfg.read_text()), "frames": 2}))
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    res = _run(tiny_root, name, seconds=0.5)
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


@pytest.mark.parametrize("cell", ["vox10_body.intra_raht",
                                  "lidar_hdl64.intra_raht",
                                  "lidar_hdl64.geom_only"])
def test_controls_fail(tiny_root, cell):
    c = spec.load_cell(cell, root=tiny_root)
    got = control.readings(c, SEED)
    assert not check.passes(got["control_geometry"], check.LIMITS)
    if "intra_raht" in cell:
        assert not check.passes(got["control_float32"], c.check().LIMITS)


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_without_the_port_the_run_fails(tiny_root):
    """A checkout holding only BENCHMARK.json and pccbench/ cannot run."""
    code = ("import sys; from pccbench import run, spec; "
            "run.run_cell(spec.load_cell('lidar_hdl64.geom_only'), 1, 0.1, "
            "False, 'cpu')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(tiny_root)})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "mpeg_pcc_tmc13_tpu_torch" in proc.stderr


def test_forbidden_modules_named_whole(monkeypatch):
    assert "mpeg_pcc_tmc13_tpu_torch" in sys.modules
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
