"""Port parity: the evaluation scripts of the port
(``mpeg_pcc_tmc13_tpu_torch.scripts``) against the repo's ``scripts/`` on
the same seeded inputs, tolerance 0 throughout (bytes, md5s, PSNRs: the
same host arithmetic on the same streams).

The scripts start their CLI as a child process; here that child runs in
this process instead (``IN_PROCESS`` stands in for the script's
``subprocess`` module and calls the named CLI's ``main``), so the JAX CLI
and the port's ``tmc3-cuda`` run without a process start each.
"""

import contextlib
import filecmp
import hashlib
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from mpeg_pcc_tmc13_tpu.runtime import cli as jcli
from mpeg_pcc_tmc13_tpu_torch.runtime import cli as tcli
from mpeg_pcc_tmc13_tpu_torch.scripts import collate_logs as tcollate
from mpeg_pcc_tmc13_tpu_torch.scripts import ctc_matrix as tctc
from mpeg_pcc_tmc13_tpu_torch.scripts import gen_clouds as tgen
from mpeg_pcc_tmc13_tpu_torch.scripts import gen_ctc_cfg as tcfg
from mpeg_pcc_tmc13_tpu_torch.scripts import mesh_scaling as tmesh
from mpeg_pcc_tmc13_tpu_torch.scripts import parity as tparity
from mpeg_pcc_tmc13_tpu_torch.utils import ply
from mpeg_pcc_tmc13_tpu_torch.utils.device import NoDeviceError

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference(name):
    """The repo's ``scripts/<name>.py``, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jgen = _reference("gen_clouds")
jctc = _reference("ctc_matrix")
jparity = _reference("parity")
jcfg = _reference("gen_ctc_cfg")
jcollate = _reference("collate_logs")

_CLIS = {"mpeg_pcc_tmc13_tpu.runtime.cli": jcli.main,
         "mpeg_pcc_tmc13_tpu_torch.runtime.cli": tcli.main}


def _run_in_process(cmd, capture_output=True, text=True):
    """``subprocess.run`` of ``python -m <cli> args``: that CLI's ``main``
    in this process, its output captured."""
    assert cmd[0] == sys.executable and cmd[1] == "-m", cmd
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = _CLIS[cmd[2]](list(cmd[3:]))
    return subprocess.CompletedProcess(cmd, rc, out.getvalue(),
                                       err.getvalue())


IN_PROCESS = types.SimpleNamespace(run=_run_in_process)


def _cli(main, args):
    """Run a CLI's ``main`` in this process; returns its stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(args))
    assert rc == 0, out.getvalue()[-2000:]
    return out.getvalue()


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# -- gen_clouds --------------------------------------------------------------

@pytest.mark.parametrize("n,bits,seed", [(3000, 8, 0), (8000, 10, 3)])
def test_make_surface_matches_reference(n, bits, seed):
    got, want = tgen.make_surface(n, bits, seed), jgen.make_surface(
        n, bits, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("frame,lasers,steps,seed",
                         [(0, 64, 300, 0), (2, 16, 500, 4)])
def test_make_lidar_frame_matches_reference(frame, lasers, steps, seed):
    got = tgen.make_lidar_frame(frame, lasers, steps, seed)
    want = jgen.make_lidar_frame(frame, lasers, steps, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_gen_clouds_main_writes_the_reference_files(tmp_path, monkeypatch):
    """The command line writes the reference's files byte for byte."""
    runs = (["surface", "s.ply", "--points", "4000"],
            ["lidar", "l_%04d.ply", "--frames", "2", "--steps", "300"],
            ["surface", "a.ply", "--points", "2000", "--ascii"])
    for side, run in (("t", lambda a: tgen.main(a)),
                      ("j", lambda a: jgen.main())):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        for args in runs:
            monkeypatch.setattr(sys, "argv", ["gen_clouds.py", *args])
            with contextlib.redirect_stdout(io.StringIO()):
                run(args)
    t, j = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert sorted(t) == ["a.ply", "l_0000.ply", "l_0001.ply", "s.ply"]
    assert t == j


# -- ctc_matrix --------------------------------------------------------------

CTC_POINTS = 3000


def test_ctc_configs_match_reference():
    assert tctc.CONFIGS == jctc.CONFIGS and len(tctc.CONFIGS) == 14


def _ctc_summary(module, argv, monkeypatch):
    monkeypatch.setattr(module, "subprocess", IN_PROCESS)
    monkeypatch.setattr(sys, "argv", ["ctc_matrix.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main()
    summary = json.loads(out.getvalue())
    assert rc == (0 if summary["ok"] else 1)
    return summary


def test_ctc_matrix_matches_reference(tmp_path, monkeypatch):
    """Every family through the port's CLI gives the JAX CLI's stream and
    decoded PLY (md5), sizes and lossless checks, on a seeded cloud."""
    sums = {}
    for side, mod in (("t", tctc), ("j", jctc)):
        work = tmp_path / side
        work.mkdir()
        mod.synth_cloud(str(work / "in.ply"), n=CTC_POINTS)
        sums[side] = _ctc_summary(mod, [str(work / "in.ply"), str(work)],
                                  monkeypatch)
    assert (tmp_path / "t" / "in.ply").read_bytes() == (
        tmp_path / "j" / "in.ply").read_bytes()
    t, j = sums["t"], sums["j"]
    assert t["ok"] and j["ok"]
    assert sorted(t["configs"]) == sorted(tctc.CONFIGS)
    timing = ("encode_s", "decode_s")
    for name, want in j["configs"].items():
        got = t["configs"][name]
        assert "error" not in got, (name, got)
        assert {k: v for k, v in got.items() if k not in timing} == {
            k: v for k, v in want.items() if k not in timing}, name


@pytest.fixture(scope="module")
def ctc_frames(tmp_path_factory):
    """Two seeded frames of CTC_POINTS points (the inter families code
    both), written by the port's ``synth_cloud``."""
    d = tmp_path_factory.mktemp("ctc_frames")
    for f in range(2):
        tctc.synth_cloud(str(d / f"in_{f:04d}.ply"), n=CTC_POINTS,
                         seed=42 + f)
    return d


@pytest.mark.parametrize("engine", ["device", "rans"])
@pytest.mark.parametrize("family", sorted(tctc.CONFIGS))
def test_ctc_family_on_device_engines(family, engine, ctc_frames, tmp_path):
    """Each family with ``--geomEngine=device|rans``: the port on the CPU
    (``--device=cpu``) writes the JAX CLI's stream and decodes it to the
    same PLY bytes, frame by frame."""
    args = tctc.CONFIGS[family]["args"]
    inter = "--interPredictionEnabled=1" in args
    frames = 2 if inter else 1
    src = str(ctc_frames / "in_%04d.ply")
    got = {}
    for side, main, extra in (("t", tcli.main, ["--device=cpu"]),
                              ("j", jcli.main, [])):
        bin_path = tmp_path / f"{side}.bin"
        rec = str(tmp_path / f"{side}_%04d.ply")
        _cli(main, ["--mode=0", f"--uncompressedDataPath={src}",
                    f"--compressedStreamPath={bin_path}",
                    f"--frameCount={frames}", *args,
                    f"--geomEngine={engine}", *extra])
        _cli(main, ["--mode=1", f"--compressedStreamPath={bin_path}",
                    f"--reconstructedDataPath={rec}", *extra])
        got[side] = [bin_path.read_bytes()] + [
            open(rec % f, "rb").read() for f in range(frames)]
    assert len(got["t"][0]) > 0
    assert got["t"] == got["j"]


# -- roundtrip.sh --------------------------------------------------------------

def test_roundtrip_sh_matches_reference(tmp_path):
    """The Makefile-step contract on the port's CLI: the same stream,
    decoded PLY, md5 files and closing line as the reference step's."""
    src = tmp_path / "in.ply"
    tctc.synth_cloud(str(src), n=1500, depth=8, seed=4)
    env = dict(os.environ, PYTHONPATH=REPO)
    scripts = {"t": os.path.join(REPO, "mpeg_pcc_tmc13_tpu_torch", "scripts",
                                 "roundtrip.sh"),
               "j": os.path.join(REPO, "scripts", "roundtrip.sh")}
    last = {}
    for side, script in scripts.items():
        res = subprocess.run(["bash", script, str(src), str(tmp_path / side),
                              "--transformType=0", "--qp=22",
                              "--attribute=color"], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        last[side] = res.stdout.strip().splitlines()[-1]
    for f in ("stream.bin", "decoded.ply"):
        assert (tmp_path / "t" / f).read_bytes() == (
            tmp_path / "j" / f).read_bytes(), f
        digest = [(tmp_path / side / f"{f}.md5").read_text().split()[0]
                  for side in "tj"]
        assert digest[0] == digest[1]
    assert last["t"] == last["j"] and last["t"].startswith("ok: ")
    assert "mpeg_pcc_tmc13_tpu_torch" in (tmp_path / "t" /
                                          "encoder.log").read_text()


# -- parity ------------------------------------------------------------------

@pytest.mark.parametrize("gp", range(10, 19))
def test_ctc_pqs_matches_reference(gp):
    for r in range(1, 7):
        rate = f"r{r:02d}"
        assert tparity.ctc_pqs(gp, rate) == jparity.ctc_pqs(gp, rate)


def test_conditions_match_reference():
    """The same conditions, inputs (relative to the repository), rates
    and encoder arguments at every rate; the same per-codec extras."""
    tc, jc = tparity.conditions(), jparity.conditions()
    assert list(tc) == list(jc) and len(tc) == 8
    for name, want in jc.items():
        got = tc[name]
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "args":
                for rate in want["rates"]:
                    assert got["args"](rate) == want["args"](rate), (
                        name, rate)
            elif k == "input":
                assert os.path.relpath(got[k], tparity.ROOT) == \
                    os.path.relpath(want[k], jparity.ROOT)
            else:
                assert got[k] == want[k], (name, k)
    assert tparity.ROOT == jparity.ROOT == REPO
    assert tparity.RATE_QP == jparity.RATE_QP
    for codec in ("tmc3", "ours", "ours-ref", "ours-obuf"):
        assert tparity.codec_extra(codec) == jparity.codec_extra(codec)
    assert tparity.TMC3_DEFAULT == jparity.TMC3_DEFAULT
    assert tparity.codec_cmd("ours", "-")[1:] == [
        "-m", "mpeg_pcc_tmc13_tpu_torch.runtime.cli"]


@pytest.fixture(scope="module")
def parity_inputs(tmp_path_factory):
    """A cut-down surface (~7,700 points, 10-bit) and LiDAR frame
    (~25,000 points, 18-bit), written by the port's gen_clouds."""
    d = tmp_path_factory.mktemp("parity_inputs")
    with contextlib.redirect_stdout(io.StringIO()):
        tgen.main(["surface", str(d / "surface.ply"), "--points", "6000"])
        tgen.main(["lidar", str(d / "lidar_%04d.ply"), "--steps", "400"])
    return {"surface": str(d / "surface.ply"),
            "lidar": str(d / "lidar_0000.ply")}


_TIMING = ("enc_user_s", "dec_user_s", "enc_wall_s", "dec_wall_s",
           "enc_mpts", "dec_mpts")


@pytest.mark.parametrize("name,rate", [
    ("octree-lossy-geom", "r04"), ("octree-lossy-geom", "r01"),
    ("octree-angular", "r04"), ("predgeom-angular", "r04"),
    ("octree-raht-lossy", "r04"), ("octree-predlift-lossy", "r02"),
    ("octree-raht-lossless", "r0X")])
def test_eval_condition_matches_reference(name, rate, parity_inputs,
                                          tmp_path, monkeypatch):
    """``eval_condition`` with codec ``ours`` gives the JAX harness's
    stream, bytes, bpp and PSNRs; only the timing fields differ."""
    rows = {}
    for side, mod in (("t", tparity), ("j", jparity)):
        cond = mod.conditions()[name]
        kind = "lidar" if cond["gp"] == 18 else "surface"
        cond = dict(cond, input=parity_inputs[kind])
        monkeypatch.setattr(mod, "subprocess", IN_PROCESS)
        rows[side] = mod.eval_condition(name, cond, "ours", rate,
                                        str(tmp_path / side), "-")
    tag = f"{name}.{rate}.ours.bin"
    assert (tmp_path / "t" / tag).read_bytes() == (
        tmp_path / "j" / tag).read_bytes()
    t, j = rows["t"], rows["j"]
    assert sorted(t) == sorted(j)
    for k in j:
        if k in _TIMING:
            continue
        same = t[k] == j[k] or (isinstance(j[k], float) and math.isnan(j[k])
                                and math.isnan(t[k]))
        assert same, (k, t[k], j[k])
    assert t["points"] > 0 and not math.isnan(t["d1_psnr"])
    if "raht" in name and "lossless" not in name:
        assert math.isfinite(t["y_psnr"])


def _docs_digest():
    out = {}
    for f in ("PARITY.md", "PARITY.csv", "parity_rows.json"):
        p = os.path.join(REPO, "docs", f)
        if os.path.exists(p):
            with open(p, "rb") as fh:
                out[f] = (os.stat(p).st_mtime_ns,
                          hashlib.sha256(fh.read()).hexdigest())
    return out


def test_parity_main_writes_under_out_and_names_missing_tmc3(tmp_path):
    """Without a tmc3 binary every tmc3 row ends in an error naming the
    missing path (no row is skipped); the reports go under ``--out``;
    docs/ is untouched."""
    before = _docs_digest()
    missing = str(tmp_path / "no_build" / "tmc3")
    out = tmp_path / "out"
    with contextlib.redirect_stdout(io.StringIO()):
        rows = tparity.main(["--cond", "octree-lossy-geom", "octree-angular",
                             "--rates", "r02,r04", "--codecs", "tmc3",
                             "--tmc3", missing, "--out", str(out)])
    assert [(r["cond"], r["rate"]) for r in rows] == [
        ("octree-lossy-geom", "r02"), ("octree-lossy-geom", "r04"),
        ("octree-angular", "r02"), ("octree-angular", "r04")]
    for r in rows:
        assert r["codec"] == "tmc3" and missing in r["error"]
    assert sorted(os.listdir(out)) == ["PARITY.csv", "PARITY.md",
                                       "parity_rows.json", "runs"]
    assert json.loads((out / "parity_rows.json").read_text()) == rows
    assert _docs_digest() == before
    assert os.path.relpath(tparity.OUT_DEFAULT, REPO) == os.path.join(
        "build", "parity_torch")


def test_write_reports_matches_reference_csv(tmp_path):
    rows = [dict(cond="c", rate=r, codec=c, points=1000, geom_bpp=1.5,
                 attr_bpp=0.25, total_bpp=1.75, d1_psnr=70.1, d2_psnr=75.2,
                 y_psnr=None, refl_psnr=40.0, enc_user_s=0.5, dec_user_s=0.25,
                 enc_mpts=2.0, dec_mpts=4.0)
            for r in ("r01", "r02") for c in ("tmc3", "ours")]
    for side, mod in (("t", tparity), ("j", jparity)):
        mod.write_reports(rows, str(tmp_path / f"{side}.csv"),
                          str(tmp_path / f"{side}.md"))
    assert filecmp.cmp(tmp_path / "t.csv", tmp_path / "j.csv",
                       shallow=False)
    table = [ln for ln in (tmp_path / "t.md").read_text().splitlines()
             if ln.startswith("|")]
    assert table == [ln for ln in (tmp_path / "j.md").read_text()
                     .splitlines() if ln.startswith("|")]


# -- the cfg-tree tools --------------------------------------------------------

def _non_timing(rows):
    return [{k: v for k, v in r.items()
             if not k.endswith(("user_s", "wall_s"))} for r in rows]


def test_cfg_tree_runs_on_both_clis_and_collates(tmp_path, monkeypatch):
    """The port's gen_ctc_cfg writes the reference's tree; tmc3-cuda runs
    it (as tests/test_cli.py runs the JAX CLI on it); collate_logs gives
    the same non-timing columns on both CLIs' logs, and the reference's
    rows on the same logs."""
    src = tmp_path / "src.ply"
    tctc.synth_cloud(str(src), n=2000, depth=9, seed=3)
    seqs = tmp_path / "seqs.json"
    seqs.write_text(json.dumps([{"name": "t", "src": str(src), "gp": 9,
                                 "attrs": ["color"], "frames": 1}]))
    argv = ["--seq-json", str(seqs), "--geom", "octree", "--attr", "raht"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcfg.main(["--out", str(tmp_path / "cfg_t"), *argv]) == 0
        assert jcfg.main(["--out", str(tmp_path / "cfg_j"), *argv]) == 0
    tree = _tree(tmp_path / "cfg_t")
    assert tree == _tree(tmp_path / "cfg_j")
    # C1 6 rates + C2 6 rates + CW 1 = 13 dirs
    assert sum(p.endswith("encoder.cfg") for p in tree) == 13

    points = ["octree-raht-ctc-lossless-geom-lossless-attrs/t/r01",
              "octree-raht-ctc-lossy-geom-lossy-attrs/t/r03"]
    for side, main in (("t", tcli.main), ("j", jcli.main)):
        for point in points:
            d = tmp_path / "cfg_t" / point
            run = tmp_path / f"run_{side}" / point
            run.mkdir(parents=True)
            bs, rec = run / "o.bin", run / "r.ply"
            (run / "encoder.log").write_text(_cli(main, [
                "-c", str(d / "encoder.cfg"), f"--compressedStreamPath={bs}"]))
            (run / "decoder.log").write_text(_cli(main, [
                "-c", str(d / "decoder.cfg"), f"--compressedStreamPath={bs}",
                f"--reconstructedDataPath={rec}"]))
            assert ply.read(str(rec)).count > 0
    rows_t = tcollate.collate(str(tmp_path / "run_t"))
    rows_j = tcollate.collate(str(tmp_path / "run_j"))
    assert len(rows_t) == 2 and "encoder_positions_bytes" in rows_t[0]
    assert _non_timing(rows_t) == _non_timing(rows_j)
    assert rows_t == jcollate.collate(str(tmp_path / "run_t"))
    csv_path = tmp_path / "rows.csv"
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcollate.main([str(tmp_path / "run_t"), "-o",
                              str(csv_path)]) == 0
    assert csv_path.read_text().startswith("condition,sequence,rate,")


# -- mesh_scaling ----------------------------------------------------------------

def test_mesh_sizes():
    assert tmesh.mesh_sizes("cpu") == (1, 2, 4, 8)


def test_mesh_sizes_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        tmesh.mesh_sizes()


def test_mesh_scaling_matches_reference():
    """On host mesh entries, every mesh size's sharded frame encode gives
    the JAX script's payload bytes (on its virtual CPU devices)."""
    jmesh = _reference("mesh_scaling")
    with contextlib.redirect_stdout(io.StringIO()):
        want = jmesh.main()
        got = tmesh.main(backend="cpu")
    keys = ("devices", "points_per_device", "geom_bytes")
    assert [{k: r[k] for k in keys} for r in got] == [
        {k: r[k] for k in keys} for r in want]
    assert [r["devices"] for r in got] == [1, 2, 4, 8]
