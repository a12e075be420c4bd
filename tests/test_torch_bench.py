"""The port's benchmark (mpeg_pcc_tmc13_tpu_torch.bench) on the CPU at a
small size, held to the repo's ``bench.py`` and to the JAX library on the
same cloud: every size it prints equals the reference's (tolerance 0), its
one JSON line has ``bench.py``'s keys and no ``*_error`` key, and no path
runs without a device that was asked for or present.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from mpeg_pcc_tmc13_tpu.bitstream import entropy
from mpeg_pcc_tmc13_tpu.models import attr_raht as jam
from mpeg_pcc_tmc13_tpu.models import geometry_octree as jgo
from mpeg_pcc_tmc13_tpu.models import geometry_rans as jgr
from mpeg_pcc_tmc13_tpu.models.attributes import AttributeContexts
from mpeg_pcc_tmc13_tpu.ops import raht_fp_device as jfp
from mpeg_pcc_tmc13_tpu.runtime import device_pipeline as jdp
from mpeg_pcc_tmc13_tpu.utils import morton as jmorton
from mpeg_pcc_tmc13_tpu_torch import bench as tbench
from mpeg_pcc_tmc13_tpu_torch.runtime import roundtrip as rt
from mpeg_pcc_tmc13_tpu_torch.utils.device import NoDeviceError

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINTS = 20_000
DEPTH = 8
ARGS = ["--device=cpu", f"--points={POINTS}", f"--depth={DEPTH}"]


def _keys():
    """``BENCH_r05.json``'s line without its error key, plus the lanes it
    never ran (``device_attr_*``) and the geometry-only round trip."""
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        keys = set(json.load(f)["parsed"]) - {"device_attr_error"}
    return keys | {"device_attr_plan_s", "device_attr_encode_mpts",
                   "device_attr_bpp", "device_attr_decode_mpts",
                   "device_attr_ok", "device_geom_rt_mpts"}


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tbench.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def cloud():
    pos = rt.make_surface_cloud(POINTS, DEPTH)
    return pos, rt.sorted_unique_codes(pos)


@pytest.fixture(scope="module")
def line():
    rc, out = _main(ARGS)
    assert rc == 0
    return out


def test_main_prints_one_json_line(line):
    lines = line.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert set(got) == _keys() | {"metric", "value", "unit", "vs_baseline"}
    assert not [k for k in got if k.endswith("_error")]
    assert got["metric"] == "device_e2e_roundtrip_throughput"
    assert got["device"] == "cpu"
    assert got["device_attr_ok"] is True
    assert got["device_numerics_ok"] is True
    assert got["device_raht_max_rel_err"] < tbench.PARSEVAL_MAX
    assert got["value"] > 0 and got["vs_baseline"] == got["value"]


def test_host_sizes_match_bench(cloud, line):
    """The printed host sizes are ``bench.host_numbers``' on the same
    cloud; and with n = 8 each ``*_bpp`` is its payload's byte count, so
    the payloads are equal to the byte."""
    pos, uniq = cloud
    got = json.loads(line)
    ref = bench.host_numbers(pos, uniq, DEPTH, POINTS)
    for key in ("geom_bpp", "raht_bpp", "obuf_bpp"):
        assert got[key] == ref[key], key
    port = tbench.host_numbers(pos, uniq, DEPTH, 8)
    ref = bench.host_numbers(pos, uniq, DEPTH, 8)
    assert set(port) == set(ref)
    for key in ("geom_bpp", "raht_bpp", "obuf_bpp"):
        assert port[key] == ref[key] > 100, key


def test_device_sizes_match_jax(cloud, line):
    """Link bytes, rANS and fixed-point RAHT sizes equal the JAX
    library's on the same cloud, divided by the unique count."""
    _, uniq = cloud
    nn = uniq.size
    got = json.loads(line)
    st = jdp.PipelineStats()
    jdp.encode_pipelined(uniq, DEPTH, entropy.RangeEncoder(),
                         jgo.OctreeContexts(), num_slices=1,
                         packed_link=False, stats=st)
    assert got["link_bytes_per_point"] == round(st.link_bytes / nn, 2)
    pay = jgr.encode(jmorton.decode(uniq), DEPTH)
    assert got["rans_bpp"] == round(8 * len(pay) / nn, 3)
    enc = entropy.RangeEncoder()
    ctx = AttributeContexts()
    jfp.DeviceFpRaht(uniq, DEPTH, [jam.qp_to_step_q16(22)] * 3).encode(
        rt._colors_for(uniq, DEPTH),
        lambda q: enc.zrow_residuals(ctx.zrow, q.astype(np.int32)))
    assert got["device_attr_bpp"] == round(8 * len(enc.get_bytes()) / nn, 3)


def test_a_lane_that_raises_fails_the_run(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("lane broken")
    monkeypatch.setattr(tbench.geometry_rans, "encode", broken)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            pytest.raises(RuntimeError, match="lane broken"):
        tbench.main(["--device=cpu", "--points=2000", "--depth=6"])
    assert out.getvalue() == ""


def test_main_needs_a_device(monkeypatch):
    """Without CUDA and without --device, ``main`` raises before any
    lane runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(tbench, "host_numbers", lambda *a: ran.append(a))
    with pytest.raises(NoDeviceError):
        _main(["--points=2000", "--depth=6"])
    assert not ran


def test_command_without_device_exits_non_zero():
    """The command a user runs, on a host without CUDA and without
    --device, exits non-zero with the message and prints no line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the bench would run on it")
    res = subprocess.run(
        [sys.executable, "-m", "mpeg_pcc_tmc13_tpu_torch.bench",
         "--points=2000", "--depth=6"], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr
