"""The port's slice as a whole (mpeg_pcc_tmc13_tpu_torch.runtime.roundtrip)
on CPU tensors, held to the JAX package on the same input, plus the
port's independence from jax and ``chip_smoke.py``'s refusal to run
without a GPU.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import bench
from mpeg_pcc_tmc13_tpu.bitstream import entropy
from mpeg_pcc_tmc13_tpu.models import geometry_octree as jgo
from mpeg_pcc_tmc13_tpu.models.attributes import AttributeContexts
from mpeg_pcc_tmc13_tpu.ops import raht_device as jrd
from mpeg_pcc_tmc13_tpu.ops import raht_fp
from mpeg_pcc_tmc13_tpu.ops import raht_fp_device as jfp
from mpeg_pcc_tmc13_tpu.runtime import device_pipeline as jdp
from mpeg_pcc_tmc13_tpu_torch.models.attr_raht import qp_to_step_q16
from mpeg_pcc_tmc13_tpu_torch.ops import raht_device as trd
from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = 8
QP = 22


@pytest.fixture(scope="module")
def slice_run():
    uniq = rt.sorted_unique_codes(rt.make_surface_cloud(20_000, DEPTH))
    colors = rt._colors_for(uniq, DEPTH)
    return uniq, colors, rt.device_roundtrip(uniq, DEPTH, colors, qp=QP)


def test_cloud_and_colors_match_bench():
    pos = rt.make_surface_cloud(5000, 9, seed=3)
    assert np.array_equal(pos, bench.make_surface_cloud(5000, 9, seed=3))
    uniq = rt.sorted_unique_codes(pos)
    assert np.array_equal(rt._colors_for(uniq, 9), bench._colors_for(uniq, 9))


def test_geometry_payload_matches_jax(slice_run):
    uniq, _, r = slice_run
    assert uniq.size > 15_000
    enc = entropy.RangeEncoder()
    jdp.encode_pipelined(uniq, DEPTH, enc, jgo.OctreeContexts(),
                         num_slices=1, packed_link=False)
    assert r.geom_payload == enc.get_bytes()
    assert np.array_equal(r.decoded_codes, uniq)


def test_attribute_payload_matches_jax(slice_run):
    uniq, colors, r = slice_run
    steps = [qp_to_step_q16(QP)] * 3
    enc = entropy.RangeEncoder()
    ctx = AttributeContexts()
    jfp.DeviceFpRaht(uniq, DEPTH, steps).encode(
        colors, lambda q: enc.zrow_residuals(ctx.zrow, q.astype(np.int32)))
    assert r.attr_payload == enc.get_bytes()


def test_decoded_colors_match_spec(slice_run):
    uniq, colors, r = slice_run
    step = qp_to_step_q16(QP)
    it = iter(r.q_rows)
    ref = raht_fp.inverse_predicted_fp(
        uniq, DEPTH, lambda m, tag: next(it).astype(np.int64),
        lambda c, tag: step, 3)
    assert np.array_equal(r.decoded_colors, ref)
    assert np.abs(r.decoded_colors - colors).mean() < 4.0


def test_float_lane_inverts_and_preserves_energy(slice_run):
    _, colors, r = slice_run
    assert rt.parseval_rel_err(colors, r.raht_acs, r.raht_root) < 1e-5
    assert np.abs(r.raht_recon - colors).max() < 0.01
    assert set(r.stage_s) >= {"geom_encode", "geom_decode", "attr_encode",
                              "attr_decode", "raht_forward", "raht_inverse"}
    assert r.launches == {"fwd_blocks": 0, "inv_blocks": 0}   # CPU


def test_float_lane_matches_jax_interpret(slice_run):
    """Float RAHT coefficients within 1e-2 of the Pallas kernels in
    interpret mode at values N(0, 50) (the tolerance of
    tests/test_pallas_raht.py:55-60)."""
    uniq, _, _ = slice_run
    vals = np.random.default_rng(5).normal(0, 50, (uniq.size, 3))
    acs_t, root_t = trd.forward_device(uniq, vals, DEPTH)
    acs_j, root_j = jrd.forward_device(uniq, vals, DEPTH, interpret=True)
    np.testing.assert_allclose(root_t.numpy(), np.asarray(root_j), atol=1e-2)
    for (ct, mt), (cj, mj) in zip(acs_t, acs_j):
        assert np.array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-2)


_JAX_BLOCKED = textwrap.dedent("""
    import sys

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ModuleNotFoundError("jax is blocked: " + name)
            return None

    sys.meta_path.insert(0, _NoJax())
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt
    uniq = rt.sorted_unique_codes(rt.make_surface_cloud(3000, 6))
    colors = rt._colors_for(uniq, 6)
    r = rt.device_roundtrip(uniq, 6, colors, qp=22, device="cpu")
    assert np.array_equal(r.decoded_codes, uniq)
    assert r.decoded_colors.shape == colors.shape
    assert np.abs(r.raht_recon - colors).max() < 0.01

    # every module of the port imports, and the on-device geometry
    # engines run: a rANS round trip and an engine="device" encode
    import importlib
    import pkgutil
    import mpeg_pcc_tmc13_tpu_torch as pkg
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
    from mpeg_pcc_tmc13_tpu_torch import host
    from mpeg_pcc_tmc13_tpu_torch.models import geometry_octree as go
    from mpeg_pcc_tmc13_tpu_torch.models import geometry_rans as gr
    from mpeg_pcc_tmc13_tpu_torch.ops import octree
    from mpeg_pcc_tmc13_tpu_torch.utils import morton
    pos = morton.decode(uniq)
    out = gr.decode(gr.encode(pos, 6, device="cpu"), uniq.size, 6,
                    device="cpu")
    assert np.array_equal(out, pos)
    streams = []
    for engine in ("device", "native"):
        enc = host.RangeEncoder()
        go.encode(pos, 6, enc, go.OctreeContexts(), engine=engine,
                  ctx_mode=octree.CTX_MODE_NEIGH, device="cpu")
        streams.append(enc.get_bytes())
    assert streams[0] == streams[1]

    # the port's CLI: a rANS + RAHT colour encode and its decode
    import os
    import tempfile
    from mpeg_pcc_tmc13_tpu.utils import ply
    from mpeg_pcc_tmc13_tpu_torch.runtime import cli
    cols = (pos * 37 % 256).astype(np.uint16)
    flags = ["--geomEngine=rans", "--device=cpu"]
    with tempfile.TemporaryDirectory() as d:
        ply.write(ply.PlyCloud(positions=pos.astype(np.float64),
                               colors=cols),
                  os.path.join(d, "in.ply"), position_is_float=False)
        assert cli.main(["--mode=0", "--uncompressedDataPath=" + d
                         + "/in.ply", "--compressedStreamPath=" + d
                         + "/s.bin", "--attribute=color", *flags]) == 0
        assert cli.main(["--mode=1", "--compressedStreamPath=" + d
                         + "/s.bin", "--reconstructedDataPath=" + d
                         + "/out.ply", *flags]) == 0
        rec = ply.read(os.path.join(d, "out.ply"))
    assert np.array_equal(morton.encode(rec.positions.astype(np.int64)),
                          uniq)
    assert not any(m == "jax" or m.startswith(("jax.", "jaxlib"))
                   for m in sys.modules)
    print("NO_JAX_OK", uniq.size)
""")


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _JAX_BLOCKED], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py imports neither jax nor the JAX package: what it
    needs of the shared host layer comes through the port's ``host``."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    bad = {m for m in mods
           if m.split(".")[0] in ("jax", "jaxlib", "mpeg_pcc_tmc13_tpu")}
    assert not bad, bad
    assert "mpeg_pcc_tmc13_tpu_torch" in mods


def _last_json(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return None
    try:
        return json.loads(lines[-1])
    except ValueError:
        return None


def test_chip_smoke_fails_without_gpu():
    """No CUDA here (a CPU-only torch): chip_smoke.py exits non-zero and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert _last_json(res.stdout) is None
    assert "cuda" in res.stderr.lower()


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory without the rest of the repo it cannot
    run either."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert _last_json(res.stdout) is None
