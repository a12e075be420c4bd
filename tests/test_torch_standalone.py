"""The port stands alone: it imports nothing of jax or of the JAX package,
its native calls go to its own library (built from its own ``native/``),
its host range coder matches the reference's bit for bit, and its entry
points run on the card unless the caller asks for another device.
"""

import ast
import ctypes
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mpeg_pcc_tmc13_tpu.bitstream import entropy as jentropy
from mpeg_pcc_tmc13_tpu.models import geometry_octree as jgo
from mpeg_pcc_tmc13_tpu_torch.bitstream import entropy as tentropy
from mpeg_pcc_tmc13_tpu_torch.models import geometry_octree as tgo
from mpeg_pcc_tmc13_tpu_torch.ops import octree as tops
from mpeg_pcc_tmc13_tpu_torch.ops import raht_device, raht_fp_device
from mpeg_pcc_tmc13_tpu_torch.parallel import frame as pframe
from mpeg_pcc_tmc13_tpu_torch.parallel import slices as pslices
from mpeg_pcc_tmc13_tpu_torch.parallel.dryrun import dryrun_multichip
from mpeg_pcc_tmc13_tpu_torch.runtime import device_pipeline as dp
from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt
from mpeg_pcc_tmc13_tpu_torch.utils import morton
from mpeg_pcc_tmc13_tpu_torch.utils.device import NoDeviceError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mpeg_pcc_tmc13_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "mpeg_pcc_tmc13_tpu")


def _imports(path):
    """Every module an import statement of ``path`` names, at any depth
    (imports inside functions included), relative ones resolved."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    rel = os.path.relpath(path, REPO)[:-3].split(os.sep)
    if rel[-1] == "__init__":
        rel = rel[:-1]
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = rel[:len(rel) - node.level + (
                    path.endswith("__init__.py"))]
                mods.append(".".join(base + ([node.module]
                                             if node.module else [])))
            else:
                mods.append(node.module)
    return mods


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_module_imports_jax_or_the_reference():
    assert len(_sources()) > 40
    bad = {}
    for path in _sources():
        hits = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
        if hits:
            bad[os.path.relpath(path, REPO)] = hits
    assert not bad, bad
    # the scan resolves relative imports into the port's own package
    mods = _imports(os.path.join(PKG, "host.py"))
    assert "mpeg_pcc_tmc13_tpu_torch.bitstream.entropy" in mods
    # and walks every subpackage, the multi-device layer included
    scanned = {os.path.relpath(p, PKG) for p in _sources()}
    for name in ("slices.py", "frame.py", "dryrun.py"):
        assert os.path.join("parallel", name) in scanned, name
    assert "mpeg_pcc_tmc13_tpu_torch.utils.device" in _imports(
        os.path.join(PKG, "parallel", "slices.py"))
    # and the evaluation layer: the scripts, pc_error, the OBUF mirror
    for name in ("__init__.py", "gen_clouds.py", "ctc_matrix.py",
                 "parity.py", "gen_ctc_cfg.py", "collate_logs.py",
                 "mesh_scaling.py"):
        assert os.path.join("scripts", name) in scanned, name
    assert os.path.join("tools", "pc_error.py") in scanned
    assert os.path.join("ops", "octree_obuf.py") in scanned
    mods = _imports(os.path.join(PKG, "scripts", "parity.py"))
    assert "mpeg_pcc_tmc13_tpu_torch.tools" in mods
    assert "mpeg_pcc_tmc13_tpu_torch.scripts.gen_clouds" in mods


def test_roundtrip_script_drives_the_ports_cli():
    """The shell step (not scanned above) runs ``tmc3-cuda``'s module."""
    with open(os.path.join(PKG, "scripts", "roundtrip.sh")) as f:
        text = f.read()
    assert 'CLI="python -m mpeg_pcc_tmc13_tpu_torch.runtime.cli"' in text
    assert "mpeg_pcc_tmc13_tpu." not in text


def test_native_library_is_the_ports_own():
    """Loaded, from the port's build directory, built from its own
    sources: not the reference package's library."""
    assert tentropy.native_available()
    build = os.path.join(REPO, "build", "tmc13_native")
    assert os.path.dirname(tentropy.LIB_PATH) == build
    assert tentropy.LIB_PATH == tentropy._library_path()
    assert tentropy._LIB._name == tentropy.LIB_PATH
    assert os.path.realpath(tentropy.LIB_PATH) != os.path.realpath(
        jentropy._SO_PATH)
    assert tentropy._NATIVE_DIR == os.path.join(PKG, "native")
    for src in tentropy._SOURCES:
        assert os.path.exists(os.path.join(tentropy._NATIVE_DIR, src))
    assert "-march=native" not in tentropy.CXXFLAGS
    assert "-ffp-contract=off" in tentropy.CXXFLAGS


_BUILD_ONE = textwrap.dedent("""
    import ctypes, sys
    from mpeg_pcc_tmc13_tpu_torch.bitstream import entropy as e
    e._BUILD_DIR = sys.argv[1]
    e._SOURCES = ("lod.cc",)
    so = e._library_path()
    secs = e._build(so)
    ctypes.CDLL(so)
    print(so, secs)
""")


def test_native_build_is_locked(tmp_path):
    """Processes that build together build once: one compiles, the
    others wait on the lock and load the finished library; no temporary
    file is left behind.  (One small source keeps the test fast.)"""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE,
                               str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
        outs.append(out.split())
    assert len({so for so, _ in outs}) == 1
    assert sorted(float(s) > 0 for _, s in outs) == [False] * 3 + [True]
    left = sorted(os.listdir(tmp_path))
    assert left == sorted(["build.lock", os.path.basename(outs[0][0])])


# -- the two range coders, bit for bit ------------------------------------

def _occ_bytes(seed):
    rng = np.random.default_rng(seed)
    codes = np.unique(morton.encode(rng.integers(0, 64, (900, 3))))
    return np.concatenate([lv["occ"] for lv in tops.build_levels_np(
        codes, 6, tops.CTX_MODE_PARENT)]).astype(np.uint8)


def _coder_case(kind, ent, rng):
    """(encode(enc), decode(dec) -> values, the values) of one coder
    method on seeded inputs, with contexts from package ``ent``."""
    if kind == "bits":
        ids = rng.integers(0, 16, 3000).astype(np.int32)
        bits = (rng.random(3000) < 0.2).astype(np.uint8)
        return (lambda e: e.bits(ent.new_contexts(16), ids, bits),
                lambda d: d.bits(ent.new_contexts(16), ids), bits)
    if kind == "bypass":
        nbits = rng.integers(1, 17, 800).astype(np.int32)
        vals = (rng.integers(0, 1 << 16, 800)
                & ((1 << nbits) - 1)).astype(np.uint32)
        return (lambda e: e.bypass(vals, nbits),
                lambda d: d.bypass(nbits), vals)
    if kind == "ueg":
        bases = rng.integers(0, 3, 800).astype(np.int32) * 10
        vals = rng.integers(0, 500, 800).astype(np.uint32)
        return (lambda e: e.ueg(ent.new_contexts(32), bases, vals, 8, 2),
                lambda d: d.ueg(ent.new_contexts(32), bases, 8, 2), vals)
    if kind == "occ_stream":
        occ = _occ_bytes(int(rng.integers(1 << 30)))
        ctx = (tgo if ent is tentropy else jgo).OctreeContexts
        return (lambda e: e.occ_stream(ctx().occupancy_sym, occ, 6),
                lambda d: d.occ_stream(ctx().occupancy_sym, occ.size + 64,
                                       6)[:occ.size], occ)
    if kind == "zrow":
        rows = rng.integers(-30, 31, (1500, 3)).astype(np.int32)
        rows[rng.random(1500) < 0.7] = 0
        return (lambda e: e.zrow_residuals(ent.new_contexts(31), rows),
                lambda d: d.zrow_residuals(ent.new_contexts(31), 1500, 3),
                rows)
    res = (rng.standard_normal(2000) * 5).astype(np.int32)
    return (lambda e: e.residuals(ent.new_contexts(32), res, 12, 1),
            lambda d: d.residuals(ent.new_contexts(32), res.size, 12, 1),
            res)


@pytest.mark.parametrize("kind", ["bits", "bypass", "ueg", "occ_stream",
                                  "zrow", "residuals"])
def test_range_coders_match_reference(kind):
    """The port's coder writes the reference's bytes from the same
    seeded inputs, and each decodes the other's stream to them."""
    streams, values = [], []
    for ent in (tentropy, jentropy):
        enc_fn, _, vals = _coder_case(kind, ent, np.random.default_rng(7))
        enc = ent.RangeEncoder()
        enc_fn(enc)
        streams.append(enc.get_bytes())
        values.append(vals)
    assert np.array_equal(values[0], values[1])
    assert len(streams[0]) > 0 and streams[0] == streams[1]
    for ent, stream in ((tentropy, streams[1]), (jentropy, streams[0])):
        _, dec_fn, vals = _coder_case(kind, ent, np.random.default_rng(7))
        assert np.array_equal(np.asarray(dec_fn(ent.RangeDecoder(stream))),
                              vals)


# -- the card by default ---------------------------------------------------

def _entry_points():
    uniq = rt.sorted_unique_codes(rt.make_surface_cloud(400, 4))
    colors = rt._colors_for(uniq, 4)
    vals = colors.astype(np.float32)
    acs, root = raht_device.forward_device(uniq, vals, 4, device="cpu")
    enc = tentropy.RangeEncoder()
    dp.encode_pipelined(uniq, 4, enc, tgo.OctreeContexts(), num_slices=1,
                        device="cpu")
    stream = enc.get_bytes()
    return {
        "device_roundtrip": lambda: rt.device_roundtrip(uniq, 4, colors),
        "encode_pipelined": lambda: dp.encode_pipelined(
            uniq, 4, tentropy.RangeEncoder(), tgo.OctreeContexts(),
            num_slices=1),
        "decode_pipelined": lambda: dp.decode_pipelined(
            tentropy.RangeDecoder(stream), tgo.OctreeContexts(), 4, 1,
            uniq.size),
        "forward_device": lambda: raht_device.forward_device(uniq, vals, 4),
        "inverse_device": lambda: raht_device.inverse_device(
            uniq, acs, root, 4),
        "DeviceFpRaht": lambda: raht_fp_device.DeviceFpRaht(
            uniq, 4, [1 << 16] * 3),
        "make_mesh": lambda: pslices.make_mesh(2),
        "devices_for": lambda: pframe.devices_for(2),
        "dryrun_multichip": lambda: dryrun_multichip(2),
    }


@pytest.mark.parametrize("name", ["device_roundtrip", "encode_pipelined",
                                  "decode_pipelined", "forward_device",
                                  "inverse_device", "DeviceFpRaht",
                                  "make_mesh", "devices_for",
                                  "dryrun_multichip"])
def test_entry_point_needs_a_device(name, monkeypatch):
    """Called without ``device`` an entry point takes the current CUDA
    device; with none present it raises instead of running on the host."""
    call = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        call()


def test_library_symbols_are_bound_by_name():
    """Every entry point the port binds is defined by its own library,
    those of the tmc3-syntax and trisoup units (``refattr.cc``,
    ``refpredlift.cc``, ``trisoup_ref.cc``, ``trisoup_geom.cc``) too:
    thirteen units, as the reference links."""
    assert len(tentropy._SOURCES) == 13
    lib = ctypes.CDLL(tentropy.LIB_PATH)
    for sym in ("rce_new", "oct_encode", "raht_encode_fp", "knn_float",
                "lod_assign_dist2", "obufls_encode_octree",
                "tmc13ref_decode_octree_intra", "tmc13_div_approx",
                "tmc13ref_decode_raht_attr", "tmc13ref_isqrt",
                "tmc13ref_decode_predlift", "tmc13ref_encode_predlift",
                "tsgeom_open",
                "tsref_open"):
        assert hasattr(lib, sym), sym


def test_conformance_load_binds_the_ports_library(monkeypatch):
    """``conformance.decoder._load`` hands out the port's own library,
    runs no ``make``, and raises when the library did not build."""
    from mpeg_pcc_tmc13_tpu.conformance import decoder as jdec
    from mpeg_pcc_tmc13_tpu_torch.conformance import decoder as tdec
    lib = tdec._load()
    assert lib is tentropy._LIB
    assert lib._name == tentropy.LIB_PATH != jdec._SO_PATH
    assert lib.tsref_open.restype is ctypes.c_void_p
    assert lib.tsgeom_open.restype is ctypes.c_void_p
    assert not hasattr(tdec, "subprocess")
    monkeypatch.setattr(tdec, "_lib", None)
    monkeypatch.setattr(tentropy, "_LIB", None)
    with pytest.raises(RuntimeError, match="did not build"):
        tdec._load()


# -- the evaluation scripts with the reference blocked ---------------------

# installed in every process started with this directory on PYTHONPATH
# (the script below and each CLI process the conformance matrix starts)
_BLOCKER = textwrap.dedent("""
    import os
    import sys

    class _NoReference:
        def find_spec(self, name, path=None, target=None):
            if (name in ("jax", "mpeg_pcc_tmc13_tpu")
                    or name.startswith(("jax.", "jaxlib",
                                        "mpeg_pcc_tmc13_tpu."))):
                raise ModuleNotFoundError("blocked: " + name)
            return None

    sys.meta_path.insert(0, _NoReference())
    with open(os.environ["BLOCKED_LOG"], "a") as f:
        f.write(str(os.getpid()) + "\\n")
""")

_EVAL_SCRIPT = textwrap.dedent("""
    import contextlib
    import io
    import json
    import sys

    from mpeg_pcc_tmc13_tpu_torch.scripts import ctc_matrix
    from mpeg_pcc_tmc13_tpu_torch.tools import pc_error

    src, work, families = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
    ctc_matrix.CONFIGS = {k: ctc_matrix.CONFIGS[k] for k in families}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ctc_matrix.main([src, work])
    summary = json.loads(out.getvalue())
    assert rc == 0 and summary["ok"], summary
    rec = work + "/" + families[0] + ".ply"
    assert pc_error.main(["--fileA", src, "--fileB", rec,
                          "--resolution", "511"]) == 0
    assert not any(m.split(".")[0] in ("jax", "jaxlib", "mpeg_pcc_tmc13_tpu")
                   for m in sys.modules)
    print(json.dumps(summary))
""")

_BLOCKED_FAMILIES = ("octree-raht-lossy", "octree-predlift",
                     "predgeom-angular")


def test_evaluation_scripts_run_with_jax_blocked(tmp_path):
    """With jax and the JAX package blocked in every process, the port's
    conformance matrix (three families, each CLI in a process of its
    own) and pc_error run on a tiny cloud: the md5s are the JAX CLI's,
    the PSNR lines the reference tool's."""
    import contextlib
    import importlib.util
    import io
    import json

    from mpeg_pcc_tmc13_tpu.runtime import cli as jcli
    from mpeg_pcc_tmc13_tpu_torch.scripts import ctc_matrix
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(_BLOCKER)
    log = tmp_path / "blocked.log"
    src = tmp_path / "in.ply"
    ctc_matrix.synth_cloud(str(src), n=400, depth=9, seed=5)
    work = tmp_path / "work"
    env = dict(os.environ, BLOCKED_LOG=str(log),
               PYTHONPATH=os.pathsep.join([str(blocker), REPO]))
    res = subprocess.run(
        [sys.executable, "-c", _EVAL_SCRIPT, str(src), str(work),
         ",".join(_BLOCKED_FAMILIES)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    # the script's own process and the two CLI processes of every family
    assert len(log.read_text().split()) == 1 + 2 * len(_BLOCKED_FAMILIES)
    lines = res.stdout.strip().splitlines()
    summary = json.loads(lines[-1])
    for name in _BLOCKED_FAMILIES:
        bin_path, rec = tmp_path / f"{name}.bin", tmp_path / f"{name}.ply"
        with contextlib.redirect_stdout(io.StringIO()):
            assert jcli.main(["--mode=0", f"--uncompressedDataPath={src}",
                              f"--compressedStreamPath={bin_path}",
                              *ctc_matrix.CONFIGS[name]["args"]]) == 0
            assert jcli.main(["--mode=1", f"--compressedStreamPath={bin_path}",
                              f"--reconstructedDataPath={rec}"]) == 0
        got = summary["configs"][name]
        assert got["stream_md5"] == ctc_matrix.md5(str(bin_path)), name
        assert got["decoded_md5"] == ctc_matrix.md5(str(rec)), name
    spec = importlib.util.spec_from_file_location(
        "reference_pc_error", os.path.join(REPO, "tools", "pc_error.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert ref.main(["--fileA", str(src), "--fileB",
                         str(work / f"{_BLOCKED_FAMILIES[0]}.ply"),
                         "--resolution", "511"]) == 0
    assert "\n".join(lines[:-1]).endswith(out.getvalue().strip())
    assert "mseF,PSNR (p2plane)" in out.getvalue()
