"""Port parity: the port's pc_error (``mpeg_pcc_tmc13_tpu_torch.tools.
pc_error``) against the reference tool ``tools/pc_error.py``.

The five analytic cases of tests/test_pc_error.py hold the port to their
closed-form answers (same tolerances) and to the reference's result dict;
``compute`` and ``main`` on seeded colour and reflectance clouds give the
reference's dict and lines exactly (tolerance 0: both are the same host
numpy/scipy arithmetic).
"""

import contextlib
import importlib.util
import io
import os

import numpy as np
import pytest

from mpeg_pcc_tmc13_tpu.utils import ply as jply
from mpeg_pcc_tmc13_tpu_torch.tools import pc_error
from mpeg_pcc_tmc13_tpu_torch.utils import ply

_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "reference_pc_error", os.path.join(_root, "tools", "pc_error.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)


def _clouds(positions, colors=None, reflectances=None):
    """The same cloud as the port's PlyCloud and the reference's."""
    return tuple(mod.PlyCloud(
        positions=np.array(positions, dtype=np.float64),
        colors=None if colors is None else np.array(colors),
        reflectances=None if reflectances is None else np.array(
            reflectances)) for mod in (ply, jply))


def _grid(spacing=4, n=8):
    ax = np.arange(n) * spacing
    return np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.float64)


def _plane():
    ax = np.arange(32) * 2.0
    g = np.stack(np.meshgrid(ax, ax, indexing="ij"), axis=-1).reshape(-1, 2)
    return np.concatenate([g, np.zeros((g.shape[0], 1))], axis=1)


def _case_identical():
    a = _clouds(_grid())
    return [(a, a, dict(resolution=100.0))], lambda rs: (
        rs[0]["d1_mse"] == 0.0 and np.isinf(rs[0]["d1_psnr"]))


def _case_known_shift():
    g = _grid(spacing=4)
    cases = [(_clouds(g), _clouds(g + np.array([1.0, 0, 0])),
              dict(resolution=100.0, with_d2=False))]
    expect = 10.0 * np.log10(3.0 * 100.0 * 100.0 / 1.0)
    return cases, lambda rs: (abs(rs[0]["d1_mse"] - 1.0) < 1e-12
                              and abs(rs[0]["d1_psnr"] - expect) < 1e-9)


def _case_d2_plane():
    p = _plane()
    cases = [(_clouds(p), _clouds(p + np.array([0, 0, 0.5])),
              dict(resolution=10.0)),
             (_clouds(p), _clouds(p + np.array([0.5, 0, 0])),
              dict(resolution=10.0))]
    return cases, lambda rs: (abs(rs[0]["d2_mse"] - 0.25) < 0.02
                              and rs[1]["d2_mse"] < 0.02
                              and abs(rs[1]["d1_mse"] - 0.25) < 1e-9)


def _case_symmetric_max():
    g = _grid(spacing=4)
    b = np.concatenate([g, [[1000.0, 1000.0, 1000.0]]])
    return [(_clouds(g), _clouds(b), dict(resolution=100.0,
                                          with_d2=False))], \
        lambda rs: rs[0]["d1_mse"] > 100.0


def _case_colour():
    g = _grid()
    ca = np.tile(np.array([[100, 150, 200]]), (g.shape[0], 1))
    cb = ca.copy()
    cb[:, 0] += 10
    ey = 0.2126 * 10
    expect = 10.0 * np.log10(255.0 ** 2 / (ey * ey))
    return [(_clouds(g, ca), _clouds(g, cb), dict(resolution=100.0,
                                                  with_d2=False))], \
        lambda rs: abs(rs[0]["y_psnr"] - expect) < 1e-6


_ANALYTIC = {"identical": _case_identical, "known_shift": _case_known_shift,
             "d2_plane": _case_d2_plane, "symmetric_max": _case_symmetric_max,
             "colour": _case_colour}


@pytest.mark.parametrize("case", sorted(_ANALYTIC))
def test_analytic_cases(case):
    """tests/test_pc_error.py's closed forms hold for the port, and each
    result dict equals the reference tool's."""
    cases, holds = _ANALYTIC[case]()
    got = []
    for (ta, ja), (tb, jb), kw in cases:
        r = pc_error.compute(ta, tb, **kw)
        assert r == ref.compute(ja, jb, **kw)
        got.append(r)
    assert holds(got)


def _seeded(kind, seed):
    """A seeded 10-bit cloud and a noisy, thinned, partly duplicated
    reconstruction of it, with RGB or reflectance."""
    rng = np.random.default_rng(seed)
    n = 1500
    pos = rng.integers(0, 1 << 10, (n, 3)).astype(np.float64)
    keep = rng.random(n) < 0.8
    rec = np.round(pos[keep] + rng.normal(0, 1.5, (keep.sum(), 3)))
    rec = np.concatenate([rec, rec[:40]])
    if kind == "color":
        a = rng.integers(0, 256, (n, 3))
        b = np.clip(a[keep] + rng.integers(-6, 7, (keep.sum(), 3)), 0, 255)
        b = np.concatenate([b, b[:40]])
        return _clouds(pos, colors=a), _clouds(rec, colors=b)
    a = rng.integers(0, 256, n)
    b = np.clip(a[keep] + rng.integers(-9, 10, keep.sum()), 0, 255)
    b = np.concatenate([b, b[:40]])
    return _clouds(pos, reflectances=a), _clouds(rec, reflectances=b)


@pytest.mark.parametrize("kind", ["color", "reflectance"])
@pytest.mark.parametrize("resolution", [None, 1023.0])
def test_compute_matches_reference(kind, resolution):
    (ta, ja), (tb, jb) = _seeded(kind, seed=5 + (kind == "color"))
    want = ref.compute(ja, jb, resolution=resolution)
    got = pc_error.compute(ta, tb, resolution=resolution)
    assert got == want
    key = "y_psnr" if kind == "color" else "reflectance_psnr"
    assert np.isfinite(got[key]) and np.isfinite(got["d2_psnr"])


@pytest.mark.parametrize("kind", ["color", "reflectance"])
def test_main_prints_the_reference_lines(kind, tmp_path):
    (ta, _), (tb, _) = _seeded(kind, seed=9)
    fa, fb = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    ply.write(ta, fa)
    ply.write(tb, fb)
    outs = []
    for main in (pc_error.main, ref.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["--fileA", fa, "--fileB", fb,
                         "--resolution", "1023"]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "mseF,PSNR (p2plane)" in outs[0]
