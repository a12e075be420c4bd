"""The tmc3 syntax family of the port (``--refSyntax=1``,
mpeg_pcc_tmc13_tpu_torch.conformance) held to the JAX package's.

The same seeded PLYs and flags go through both CLIs: the ``.bin`` files
and the decoded PLYs must be byte-identical, and each CLI must decode the
other's stream (no ``--refSyntax`` on decode: the family is detected from
the SPS).  ``conformance.encoder.encode_frames`` and
``conformance.decoder.decode_stream`` are also called directly.  Every
output is integer or bytes: tolerance 0.  The whole family runs on the
host, so no test here passes ``--device``.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from mpeg_pcc_tmc13_tpu.conformance import decoder as jdec
from mpeg_pcc_tmc13_tpu.conformance import encoder as jenc
from mpeg_pcc_tmc13_tpu.conformance import ref_hls as jhls
from mpeg_pcc_tmc13_tpu.runtime import cli as jcli
from mpeg_pcc_tmc13_tpu.utils import ply
from mpeg_pcc_tmc13_tpu_torch.conformance import decoder as tdec
from mpeg_pcc_tmc13_tpu_torch.conformance import encoder as tenc
from mpeg_pcc_tmc13_tpu_torch.conformance import ref_hls as thls
from mpeg_pcc_tmc13_tpu_torch.runtime import cli as tcli

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gen_clouds():
    spec = importlib.util.spec_from_file_location(
        "gen_clouds", os.path.join(REPO, "scripts", "gen_clouds.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _surface(seed, shift=0, n=3000):
    """~n points of a wavy sheet in a 128 cube, with colours and
    reflectances that vary smoothly over it."""
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 96, (n, 2)).astype(np.float64)
    z = 64 + 40 * np.sin(xy[:, 0] / 17.0) * np.cos(xy[:, 1] / 23.0)
    pos = np.unique(np.column_stack([xy, np.round(z)]).astype(np.int64),
                    axis=0) + shift
    col = np.clip(np.column_stack([pos[:, 0] * 2, pos[:, 1] * 2,
                                   pos[:, 2] * 2])
                  + rng.integers(0, 9, pos.shape), 0, 255)
    refl = np.clip(pos[:, 2] * 2 + rng.integers(0, 9, pos.shape[0]), 0, 255)
    return pos.astype(np.float64), col.astype(np.uint16), \
        refl.astype(np.uint16)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Two surface frames with colour and two with reflectance (the
    second of each moved by two voxels), and a 16-laser lidar frame."""
    d = tmp_path_factory.mktemp("refsyntax_frames")
    for i, shift in enumerate((0, 2)):
        pos, col, refl = _surface(11, shift)
        ply.write(ply.PlyCloud(positions=pos, colors=col),
                  str(d / f"c{i:04d}.ply"), position_is_float=False)
        ply.write(ply.PlyCloud(positions=pos, reflectances=refl),
                  str(d / f"r{i:04d}.ply"), position_is_float=False)
    # tests/test_conformance.py::_lidar_cloud
    lidar, _ = _gen_clouds().make_lidar_frame(0, n_lasers=16, steps=1500)
    lidar = np.unique(lidar >> 4, axis=0)            # 14-bit grid
    ply.write(ply.PlyCloud(positions=lidar.astype(np.float64)),
              str(d / "l0000.ply"), ascii=True)
    return d


def _predgeom_opts(extra=(), n_lasers=16):
    """tests/test_conformance.py::_predgeom_opts: predictive geometry
    with the angular tool set (the family refuses it without)."""
    theta = ",".join(
        f"{t:.6f}"
        for t in np.tan(_gen_clouds()._hdl64_elevations(n_lasers)))
    npt = ",".join(["2000"] * n_lasers)
    zeros = ",".join(["0"] * n_lasers)
    head = 1 << 13
    return ["--positionQuantizationScale=1", "--disableAttributeCoding=1",
            "--geomTreeType=1", "--angularEnabled=1",
            f"--numLasers={n_lasers}",
            f"--lidarHeadPosition={head},{head},{head}",
            f"--lasersTheta={theta}", f"--lasersZ={zeros}",
            f"--lasersNumPhiPerTurn={npt}", *extra]


def _encode(cli, src, out_bin, flags):
    assert cli.main(["--mode=0", "--refSyntax=1",
                     f"--uncompressedDataPath={src}",
                     f"--compressedStreamPath={out_bin}", *flags]) == 0
    return out_bin.read_bytes()


def _decode(cli, out_bin, rec, nframes=1):
    """Decode with no --refSyntax; the frames' PLY bytes."""
    assert cli.main(["--mode=1", f"--compressedStreamPath={out_bin}",
                     f"--reconstructedDataPath={rec}"]) == 0
    out = [(rec.parent / (rec.name % i)).read_bytes()
           for i in range(nframes)]
    assert not (rec.parent / (rec.name % nframes)).exists()
    return out


# per-attribute options stand before the --attribute= that closes them
FLAG_SETS = {
    "zero_flag": ("c", []),
    "zero_flag_colour": ("c", ["--attribute=color"]),
    "no_attributes": ("c", ["--disableAttributeCoding=1"]),
    "lift_reflectance": ("r", ["--planarEnabled=1", "--transformType=2",
                               "--qp=34", "--bitdepth=8",
                               "--attribute=reflectance"]),
    "raht_colour": ("c", ["--transformType=0", "--qp=22",
                          "--attribute=color"]),
    "predgeom_angular": ("l", _predgeom_opts),
    "trisoup_colour": ("c", ["--trisoupNodeSizeLog2=2",
                             "--attribute=color"]),
    "scaled_sps_rewrite": ("c", ["--positionQuantizationScale=0.5",
                                 "--attribute=color"]),
    "inter_two_frames": ("c", ["--frameCount=2",
                               "--interPredictionEnabled=1",
                               "--attribute=color"]),
    "ycgco_r": ("c", ["--colourMatrix=8", "--transformType=0", "--qp=22",
                      "--attribute=color"]),
}


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_ref_syntax_cli_matches_jax(name, frames, tmp_path):
    """Same .bin and same decoded PLYs, and each CLI decodes the other's
    stream to those PLYs."""
    tag, flags = FLAG_SETS[name]
    flags = flags() if callable(flags) else flags
    src = frames / f"{tag}%04d.ply"
    nframes = 2 if "--frameCount=2" in flags else 1
    bin_j = _encode(jcli, src, tmp_path / "j.bin", flags)
    bin_t = _encode(tcli, src, tmp_path / "t.bin", flags)
    assert bin_t == bin_j
    assert tcli.detect_ref_syntax(str(tmp_path / "t.bin"))
    units = [t for t, _ in thls.iter_ref_tlv(bin_t)]
    has_attr = thls.T_ATTR_BRICK in units
    assert has_attr == (name not in ("zero_flag", "no_attributes",
                                     "predgeom_angular"))
    assert units.count(thls.T_GEOM_BRICK) == nframes
    rec_jj = _decode(jcli, tmp_path / "j.bin", tmp_path / "jj_%04d.ply",
                     nframes)
    rec_tt = _decode(tcli, tmp_path / "t.bin", tmp_path / "tt_%04d.ply",
                     nframes)
    rec_tj = _decode(tcli, tmp_path / "j.bin", tmp_path / "tj_%04d.ply",
                     nframes)
    rec_jt = _decode(jcli, tmp_path / "t.bin", tmp_path / "jt_%04d.ply",
                     nframes)
    assert rec_tt == rec_jj
    assert rec_tj == rec_jj
    assert rec_jt == rec_jj


def test_ref_syntax_geometry_is_lossless(frames, tmp_path):
    """The zero-flag stream decodes to the input positions (as a set:
    tmc3's default merges duplicates, and the sheet has none)."""
    _encode(tcli, frames / "c%04d.ply", tmp_path / "t.bin",
            ["--attribute=color"])
    _decode(tcli, tmp_path / "t.bin", tmp_path / "t_%04d.ply")
    want = ply.read(str(frames / "c0000.ply")).positions.astype(np.int64)
    got = ply.read(str(tmp_path / "t_0000.ply")).positions.astype(np.int64)
    assert np.array_equal(np.unique(got, axis=0), np.unique(want, axis=0))
    assert got.shape == want.shape


def test_predgeom_without_angular_is_refused(frames, tmp_path, capsys):
    """Both CLIs refuse --geomTreeType=1 without the angular tool set
    under --refSyntax=1; the port ends in 'error: ...' and exit 1."""
    args = ["--mode=0", "--refSyntax=1",
            f"--uncompressedDataPath={frames / 'c0000.ply'}",
            f"--compressedStreamPath={tmp_path / 'p.bin'}",
            "--geomTreeType=1", "--disableAttributeCoding=1"]
    with pytest.raises(NotImplementedError, match="angular tool set"):
        jcli.main(list(args))
    capsys.readouterr()
    assert tcli.main(list(args)) == 1
    assert "error: " in capsys.readouterr().err


# -- the conformance modules called directly ------------------------------

ENCODE_KW = {
    "geometry": dict(),
    "planar_off_dups": dict(planar=False, unique_points=False),
    "raht_colour": dict(colours=True, attr_qp=28),
    "trisoup": dict(trisoup_node_size_log2=2, colours=True),
}


@pytest.mark.parametrize("name", list(ENCODE_KW))
def test_encode_frames_and_decode_stream_match_jax(name):
    kw = dict(ENCODE_KW[name])
    pos, col, _ = _surface(23)
    pos = pos.astype(np.int64)
    if kw.pop("colours", False):
        kw["colors"] = [col.astype(np.int64)[:, [1, 2, 0]]]
    if not kw.get("unique_points", True):
        pos = np.concatenate([pos, pos[:40]])
    stream_j = jenc.encode_frames([pos], **kw)
    stream_t = tenc.encode_frames([pos], **kw)
    assert stream_t == stream_j
    want_attrs = "colors" in kw
    frames_j, attrs_j = jdec.decode_stream(stream_j, want_attrs=True)
    frames_t, attrs_t = tdec.decode_stream(stream_t, want_attrs=True)
    assert len(frames_t) == len(frames_j) == 1
    assert np.array_equal(frames_t[0], frames_j[0])
    if want_attrs:
        assert np.array_equal(attrs_t[0], attrs_j[0])
    else:
        assert not attrs_t or attrs_t[0] is None


def test_parameter_sets_parse_and_rewrite_alike():
    """parse_sps / write_sps / write_ref_tlv (the SPS rewrite of
    --positionQuantizationScale): same fields, same bytes."""
    pos, _, _ = _surface(29)
    stream = tenc.encode_frames([pos.astype(np.int64)])
    (tj, pj), (tt, pt) = (next(iter(m.iter_ref_tlv(stream)))
                          for m in (jhls, thls))
    assert tj == tt == thls.T_SPS and pj == pt
    sj, st = jhls.parse_sps(pj), thls.parse_sps(pt)
    assert vars(st) == vars(sj)
    sj.seq_scale_num = st.seq_scale_num = 1
    sj.seq_scale_den = st.seq_scale_den = 2
    assert thls.write_sps(st) == jhls.write_sps(sj)
    assert (thls.write_ref_tlv(tt, thls.write_sps(st))
            == jhls.write_ref_tlv(tj, jhls.write_sps(sj)))


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.9])
def test_truncated_stream_fails_cleanly(cut, frames, tmp_path, capsys):
    """A tmc3-syntax stream cut short does not crash the process: the
    port's decoder does what the reference's does on the same bytes
    (the same exception type, or the same clouds)."""
    data = _encode(tcli, frames / "c%04d.ply", tmp_path / "t.bin",
                   ["--transformType=0", "--qp=22", "--attribute=color"])
    short = data[:int(len(data) * cut)]

    def outcome(mod):
        try:
            fr, at = mod.decode_stream(short, want_attrs=True)
        except Exception as e:              # noqa: BLE001
            return type(e).__name__, None
        return "ok", (fr, at)
    kind_j, out_j = outcome(jdec)
    kind_t, out_t = outcome(tdec)
    assert kind_t == kind_j
    if out_j is not None:
        assert len(out_t[0]) == len(out_j[0])
        for a, b in zip(out_t[0], out_j[0]):
            assert np.array_equal(a, b)


def test_ref_syntax_needs_no_device(frames, tmp_path, monkeypatch):
    """--refSyntax=1 encode and decode succeed with no --device on a
    machine without a card: the family asks for no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _encode(tcli, frames / "c%04d.ply", tmp_path / "t.bin",
            ["--transformType=0", "--qp=22", "--attribute=color"])
    rec = _decode(tcli, tmp_path / "t.bin", tmp_path / "t_%04d.ply")
    assert len(rec[0]) > 0
