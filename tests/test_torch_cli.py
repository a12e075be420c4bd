"""The port's tmc3-compatible CLI (mpeg_pcc_tmc13_tpu_torch.runtime.cli)
held to the JAX package's (mpeg_pcc_tmc13_tpu.runtime.cli) as a whole.

Both CLIs encode the same seeded PLY with the same flags (the port with
``--device=cpu``, so its on-device engines run their torch ops on the
host) and decode the streams.  The ``.bin`` files must be byte-identical
and the decoded PLYs identical: tolerance 0.  Beside the parity runs:
the depth-21 rANS round trip (held to the input, the reference engine
is wrong there), entropy continuation with contexts carried across from
the JAX encoder, and the refusals (no card).  The tmc3 syntax family
(``--refSyntax=1``) has its own file, tests/test_torch_refsyntax.py.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpeg_pcc_tmc13_tpu.bitstream import hls
from mpeg_pcc_tmc13_tpu.bitstream.tlv import PayloadType, iter_tlv
from mpeg_pcc_tmc13_tpu.runtime import cli as jcli
from mpeg_pcc_tmc13_tpu.runtime import encoder as jenc
from mpeg_pcc_tmc13_tpu.utils import ply
from mpeg_pcc_tmc13_tpu_torch.models import geometry_octree as tgo
from mpeg_pcc_tmc13_tpu_torch.models import geometry_predictive as tgp
from mpeg_pcc_tmc13_tpu_torch.runtime import cli as tcli
from mpeg_pcc_tmc13_tpu_torch.runtime import encoder as tenc
from mpeg_pcc_tmc13_tpu_torch.utils import morton
from mpeg_pcc_tmc13_tpu_torch.utils.device import NoDeviceError

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_cuda():
    """Skip where a CUDA device is present: it is the default device.
    Decided when the test runs, not at import, so every worker collects
    the same tests."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; it is the default device")


def _write_frame(path, seed, shift=0):
    """The cloud of tests/test_cli.py's sample_ply (3,000 points in a
    512 cube with random colours); ``shift`` moves it for a P frame."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 512, (3000, 3)).astype(np.float64)
    colors = rng.integers(0, 256, (3000, 3)).astype(np.uint16)
    ply.write(ply.PlyCloud(positions=np.clip(pos + shift, 0, 511),
                           colors=colors), str(path),
              position_is_float=False)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    _write_frame(d / "f0000.ply", 5)
    # frame 1: frame 0 moved by a few voxels, so inter prediction and
    # global motion have something to find
    _write_frame(d / "f0001.ply", 5, shift=3)
    return d


def _run(cli, args):
    assert cli.main(list(args)) == 0


def _encode_decode(cli, src, tag, flags, tmp, extra=()):
    out_bin, rec = tmp / f"{tag}.bin", tmp / f"{tag}_%04d.ply"
    _run(cli, ["--mode=0", f"--uncompressedDataPath={src}",
               f"--compressedStreamPath={out_bin}", *flags, *extra])
    _run(cli, ["--mode=1", f"--compressedStreamPath={out_bin}",
               f"--reconstructedDataPath={rec}", *extra])
    return out_bin.read_bytes(), rec


def _geometry_units(stream):
    """(GPS, [geometry brick headers]) of a native-syntax stream."""
    gps, bricks = None, []
    for buf in iter_tlv(io.BytesIO(stream)):
        if buf.type == PayloadType.GEOMETRY_PARAMETER_SET:
            gps = hls.GeometryParameterSet.parse(buf.data)
        elif buf.type == PayloadType.GEOMETRY_BRICK:
            bricks.append(hls.GeometryBrickHeader.parse(buf.data)[0])
    return gps, bricks


FLAG_SETS = {
    # tests/test_cli.py::test_encode_decode_cli (its cfg file)
    "encode_decode_cli": ["--positionQuantizationScale=1",
                          "--mergeDuplicatedPoints=1", "--transformType=3",
                          "--bitdepth=8", "--attribute=color"],
    # tests/test_cli.py::test_attribute_aps_knobs_flow_through
    "aps_knobs_pred_lod": ["--transformType=1", "--qp=10",
                           "--levelOfDetailCount=7",
                           "--numberOfNearestNeighborsInPrediction=2",
                           "--maxNumDirectPredictors=2",
                           "--adaptivePredictionThreshold=32",
                           "--rahtPredictionEnabled=0", "--attribute=color"],
    "raht": ["--transformType=0", "--qp=22", "--attribute=color"],
    "lift_recolour": ["--positionQuantizationScale=0.25",
                      "--transformType=2", "--attribute=color"],
    "planar": ["--planarEnabled=1", "--attribute=color"],
    "device_neighbour": ["--geomEngine=device", "--attribute=color"],
    "device_parent": ["--geomEngine=device",
                      "--neighbourAvailBoundaryLog2=0",
                      "--attribute=color"],
    # tests/test_rans.py::test_cli_rans_engine
    "rans": ["--geomEngine=rans", "--positionQuantizationScale=1",
             "--mergeDuplicatedPoints=1"],
    "obuf": ["--geomEngine=obuf", "--attribute=color"],
    "predictive": ["--geomTreeType=1", "--attribute=color"],
    "parallel_slices": ["--sliceMaxPoints=1000", "--parallelSlices=2",
                        "--attribute=color"],
    "inter_two_frames": ["--frameCount=2", "--interPredictionEnabled=1",
                         "--randomAccessPeriod=2", "--globalMotionEnabled=1",
                         "--attrInterPredictionEnabled=1",
                         "--attribute=color"],
    # trisoup geometry, native syntax: the numpy surface model, the
    # reference-exact brick, the octree front-end on the device engine,
    # and three slices (the seam padding runs)
    "trisoup": ["--trisoupNodeSizeLog2=2", "--attribute=color"],
    "trisoup_obuf": ["--trisoupNodeSizeLog2=2", "--geomEngine=obuf",
                     "--attribute=color"],
    "trisoup_device": ["--trisoupNodeSizeLog2=2", "--geomEngine=device",
                       "--attribute=color"],
    "trisoup_slices": ["--trisoupNodeSizeLog2=2",
                       "--sliceMaxPointsTrisoup=1000", "--attribute=color"],
}


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_cli_matches_jax(name, frames, tmp_path):
    flags = FLAG_SETS[name]
    src = frames / "f%04d.ply"
    bin_j, rec_j = _encode_decode(jcli, src, "j", flags, tmp_path)
    bin_t, rec_t = _encode_decode(tcli, src, "t", flags, tmp_path,
                                  extra=["--device=cpu"])
    assert bin_t == bin_j
    gps, bricks = _geometry_units(bin_t)
    assert gps.rans_engine == (name == "rans")
    assert gps.obuf_engine == (name in ("obuf", "trisoup_obuf"))
    assert (gps.codec_type == hls.GeometryCodecType.TRISOUP) == \
        name.startswith("trisoup")
    assert any(g.is_inter for g in bricks) == (name == "inter_two_frames")
    assert (len(bricks) > 1) == (name in ("parallel_slices",
                                          "inter_two_frames",
                                          "trisoup_slices"))
    nframes = 2 if "--frameCount=2" in flags else 1
    for i in range(nframes):
        a = (tmp_path / (rec_t.name % i)).read_bytes()
        b = (tmp_path / (rec_j.name % i)).read_bytes()
        assert a == b, f"frame {i}"
    assert not (tmp_path / (rec_t.name % nframes)).exists()
    if name.startswith("trisoup"):
        # cross decode: each CLI decodes the other's stream file
        for cli, stream, tag, extra in (
                (tcli, "j.bin", "tj", ["--device=cpu"]),
                (jcli, "t.bin", "jt", [])):
            _run(cli, ["--mode=1",
                       f"--compressedStreamPath={tmp_path / stream}",
                       f"--reconstructedDataPath={tmp_path / tag}.ply",
                       *extra])
            assert (tmp_path / f"{tag}.ply").read_bytes() == \
                (tmp_path / (rec_j.name % 0)).read_bytes()


def _uniq_rows(pos):
    codes = np.unique(morton.encode(pos.astype(np.int64)))
    return morton.decode(codes)


def test_cli_rans_depth21_is_lossless(tmp_path):
    """At depth 21 the reference rANS engine is wrong (its level key
    overflows), so the port is held to the input: the decoded positions
    are the unique input positions, and the decoded PLY equals the
    port's --geomEngine=native decode."""
    rng = np.random.default_rng(21)
    pos = rng.integers(0, 1 << 21, (2000, 3)).astype(np.float64)
    pos[0] = (1 << 21) - 1                       # the max corner
    pos = np.concatenate([pos, pos[:50]])        # duplicates merge
    src = tmp_path / "deep.ply"
    ply.write(ply.PlyCloud(positions=pos), str(src),
              position_is_float=False)
    recs = {}
    for engine in ("rans", "native"):
        _, rec = _encode_decode(tcli, src, engine,
                                [f"--geomEngine={engine}"], tmp_path,
                                extra=["--device=cpu"])
        recs[engine] = (tmp_path / (rec.name % 0)).read_bytes()
    out = ply.read(str(tmp_path / "rans_0000.ply")).positions
    assert np.array_equal(_uniq_rows(out), _uniq_rows(pos))
    assert out.shape[0] == _uniq_rows(pos).shape[0]
    assert recs["rans"] == recs["native"]


@pytest.mark.parametrize("codec", ["octree", "predictive"])
def test_entropy_continuation_with_carried_contexts(codec, frames):
    """--entropyContinuationEnabled=1 semantics: the JAX encoder codes a
    first slice, its trained contexts are carried into the port's
    encoder, and the port codes the second slice to the reference's
    bytes (octree and predictive geometry, RAHT colour)."""
    cloud = jcli._ply_to_cloud(ply.read(str(frames / "f0000.ply")))
    kw = dict(entropy_continuation=True,
              geometry_codec=(hls.GeometryCodecType.PREDICTIVE
                              if codec == "predictive"
                              else hls.GeometryCodecType.OCTREE))
    ej = jenc.FrameEncoder(jenc.EncoderParams(
        attributes=[jenc.AttributeConfig(qp=22)], **kw))
    et = tenc.FrameEncoder(tenc.EncoderParams(
        attributes=[tenc.AttributeConfig(qp=22)], **kw))
    for e in (ej, et):
        e._derive_parameter_sets(cloud)
    q = ej._prepare_frame(cloud)
    first, second = q.take(np.arange(1500)), q.take(np.arange(1500, 3000))
    ej._compress_slice(first, 0, lambda b: None, keep_ctx=False)
    # carry the trained state across (AttributeContexts is shared)
    et._geom_ctx = tgo.contexts_from_reference(ej._geom_ctx)
    et._predgeom_ctx = tgp.contexts_from_reference(ej._predgeom_ctx)
    et._attr_ctx = {i: c.copy() for i, c in ej._attr_ctx.items()}
    et._slice_id = ej._slice_id
    got_j, got_t = [], []
    ej._compress_slice(second, 0, got_j.append, keep_ctx=True)
    et._compress_slice(second, 0, got_t.append, keep_ctx=True)
    assert len(got_j) == 2                   # geometry + attribute brick
    assert [(b.type, b.data) for b in got_t] == \
        [(b.type, b.data) for b in got_j]


# -- refusals ------------------------------------------------------------

def test_device_engines_refuse_without_cuda(no_cuda, frames, tmp_path,
                                           capsys):
    """A device engine with no card and no --device exits non-zero with
    the message; so does decoding a rANS stream that way.  The host
    engines need no device."""
    src = frames / "f0000.ply"
    out = tmp_path / "o.bin"
    for engine in ("rans", "device"):
        assert tcli.main(["--mode=0", f"--uncompressedDataPath={src}",
                          f"--compressedStreamPath={out}",
                          f"--geomEngine={engine}"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
    _run(tcli, ["--mode=0", f"--uncompressedDataPath={src}",
                f"--compressedStreamPath={out}", "--geomEngine=rans",
                "--device=cpu"])
    assert tcli.main(["--mode=1", f"--compressedStreamPath={out}",
                      f"--reconstructedDataPath={tmp_path / 'r.ply'}"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    for engine in ("native", "numpy", "auto"):
        _run(tcli, ["--mode=0", f"--uncompressedDataPath={src}",
                    f"--compressedStreamPath={out}",
                    f"--geomEngine={engine}", "--attribute=color"])
        _run(tcli, ["--mode=1", f"--compressedStreamPath={out}",
                    f"--reconstructedDataPath={tmp_path / 'r.ply'}"])


@pytest.mark.parametrize("engine", ["auto", "native", "device", "rans"])
def test_shard_devices_refuses_without_cuda(no_cuda, frames, tmp_path,
                                            engine):
    """Without CUDA, --shardDevices=2 runs host engines' slice workers
    unplaced and writes tmc3-tpu's bytes and PLY (the reference places
    them on its CPU devices); the device engines are still refused."""
    if engine in ("device", "rans"):
        cloud = jcli._ply_to_cloud(ply.read(str(frames / "f0000.ply")))
        enc = tenc.FrameEncoder(tenc.EncoderParams(
            max_points_per_slice=1000, shard_devices=2, engine=engine))
        with pytest.raises(NoDeviceError, match="shardDevices"):
            enc.compress(cloud, lambda b: None)
        return
    flags = ["--sliceMaxPoints=1000", "--shardDevices=2",
             f"--geomEngine={engine}", "--attribute=color"]
    src = frames / "f0000.ply"
    port, port_rec = _encode_decode(tcli, src, "t_" + engine, flags, tmp_path)
    ref, ref_rec = _encode_decode(jcli, src, "j_" + engine, flags, tmp_path)
    assert len(port) > 0 and port == ref
    # the same bytes as the sequential encode
    seq, _ = _encode_decode(tcli, src, "seq", flags[:1] + flags[2:], tmp_path)
    assert seq == port
    assert (tmp_path / (port_rec.name % 0)).read_bytes() == (
        tmp_path / (ref_rec.name % 0)).read_bytes()


def test_shard_devices_refuses_an_explicit_device(frames, tmp_path,
                                                 capsys):
    """--shardDevices>1 round-robins the slice workers over the cards, so
    an explicit --device (which would pin them all to one) is refused
    with a message and exit code 1, before anything runs; either option
    alone is taken."""
    src = frames / "f0000.ply"
    out = tmp_path / "o.bin"
    args = ["--mode=0", f"--uncompressedDataPath={src}",
            f"--compressedStreamPath={out}", "--sliceMaxPoints=300"]
    for device in ("cpu", "cuda:0"):
        assert tcli.main([*args, "--shardDevices=2",
                          f"--device={device}"]) == 1
        err = capsys.readouterr().err
        assert "--shardDevices=2" in err and f"--device={device}" in err
        assert not out.exists()
    _run(tcli, [*args, "--shardDevices=1", "--device=cpu"])
    assert out.stat().st_size > 0


def test_trisoup_and_ref_syntax_not_ported(frames, tmp_path):
    """Keeps its name from when both were refused.  Now: the command
    line a user runs takes trisoup and ``--refSyntax=1``, decodes both
    streams with no flag, and the refusal strings are gone."""
    assert not hasattr(tcli, "REF_SYNTAX_NOT_PORTED")
    assert not hasattr(tenc, "TRISOUP_NOT_PORTED")
    src = frames / "f0000.ply"
    env = dict(os.environ, PYTHONPATH=REPO)
    for flags, tag in ((["--trisoupNodeSizeLog2=3"], "trisoup"),
                       (["--refSyntax=1", "--attribute=color"], "ref")):
        out, rec = tmp_path / f"{tag}.bin", tmp_path / f"{tag}.ply"
        for args in (["--mode=0", f"--uncompressedDataPath={src}",
                      f"--compressedStreamPath={out}", *flags],
                     ["--mode=1", f"--compressedStreamPath={out}",
                      f"--reconstructedDataPath={rec}"]):
            res = subprocess.run(
                [sys.executable, "-m",
                 "mpeg_pcc_tmc13_tpu_torch.runtime.cli", *args],
                cwd=REPO, env=env, capture_output=True, text=True,
                timeout=300)
            assert res.returncode == 0, res.stderr[-2000:]
            assert "not ported" not in res.stderr
        assert ply.read(str(rec)).positions.shape[0] > 0
