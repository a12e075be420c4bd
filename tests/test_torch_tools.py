"""The port's out-of-codec tools held to the JAX package's.

``tools/ply_merge`` (merge frames into one cloud tagged by
``frameindex``, split them back) runs on seeded frames through both
packages: the written PLY files must be byte-identical.  Tolerance 0.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from mpeg_pcc_tmc13_tpu.tools import ply_merge as jmerge
from mpeg_pcc_tmc13_tpu_torch.tools import ply_merge as tmerge
from mpeg_pcc_tmc13_tpu_torch.utils import ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KINDS = {
    "positions": (False, False),
    "colour": (True, False),
    "reflectance": (False, True),
    "colour_and_reflectance": (True, True),
}


def _frames(d, kind, first, count):
    colour, refl = KINDS[kind]
    rng = np.random.default_rng(31)
    for i in range(count):
        n = 200 + 37 * i
        ply.write(ply.PlyCloud(
            positions=rng.integers(0, 1024, (n, 3)).astype(np.float64),
            colors=(rng.integers(0, 256, (n, 3)).astype(np.uint16)
                    if colour else None),
            reflectances=(rng.integers(0, 65536, n).astype(np.uint16)
                          if refl else None)),
            str(d / f"in_{first + i:04d}.ply"), position_is_float=False)
    return str(d / "in_%04d.ply")


@pytest.mark.parametrize("kind", list(KINDS))
def test_merge_and_split_match_jax(kind, tmp_path):
    first, count = 3, 4
    src = _frames(tmp_path, kind, first, count)
    out = {}
    for tag, mod in (("j", jmerge), ("t", tmerge)):
        merged = tmp_path / f"{tag}_merged.ply"
        mod.merge(str(merged), src, first, count)
        mod.split(str(merged), str(tmp_path / f"{tag}_out_%04d.ply"), first)
        out[tag] = [merged.read_bytes()] + [
            (tmp_path / f"{tag}_out_{first + i:04d}.ply").read_bytes()
            for i in range(count)]
    assert out["t"] == out["j"]
    # the split gives the frames back, byte for byte
    for i in range(count):
        assert out["t"][1 + i] == (
            tmp_path / f"in_{first + i:04d}.ply").read_bytes()
    merged = ply.read(str(tmp_path / "t_merged.ply"))
    assert merged.count == sum(200 + 37 * i for i in range(count))
    assert np.array_equal(np.unique(merged.frame_indices), np.arange(count))


def test_split_refuses_a_cloud_without_frameindex(tmp_path):
    src = _frames(tmp_path, "colour", 0, 1)
    for mod in (jmerge, tmerge):
        with pytest.raises(SystemExit, match="frameindex"):
            mod.split(src % 0, str(tmp_path / "o_%04d.ply"))


def test_main_as_a_command(tmp_path):
    """``python -m mpeg_pcc_tmc13_tpu_torch.tools.ply_merge`` merges and
    splits; without arguments it prints its usage and exits 1."""
    src = _frames(tmp_path, "colour", 0, 2)
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "mpeg_pcc_tmc13_tpu_torch.tools.ply_merge"]
    merged = tmp_path / "m.ply"
    for args in (["merge", str(merged), src, "0", "2"],
                 ["split", str(merged), str(tmp_path / "s_%04d.ply")]):
        res = subprocess.run(cmd + args, cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
    for i in range(2):
        assert (tmp_path / f"s_{i:04d}.ply").read_bytes() == (
            tmp_path / f"in_{i:04d}.ply").read_bytes()
    res = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 1 and "Usage" in res.stdout
    assert tmerge.main([]) == 1 and jmerge.main([]) == 1
