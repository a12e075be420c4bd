"""Decoders on damaged streams: the port held to the JAX package.

Counterparts of tests/test_resilience.py (lost attribute brick,
truncated stream, truncated OBUF payload) and tests/test_fuzz.py
(random bytes into the octree and residual decoders, flipped geometry
bytes).  Each case runs both packages on the same inputs (the port's
device engines on ``device="cpu"``) and compares what happens: the
exception types raised, in order, and every decoded frame's positions
and attribute values.  Tolerance 0.
"""

import io

import numpy as np
import pytest
import torch

from mpeg_pcc_tmc13_tpu.bitstream import entropy as jentropy
from mpeg_pcc_tmc13_tpu.bitstream import hls as jhls
from mpeg_pcc_tmc13_tpu.bitstream import tlv as jtlv
from mpeg_pcc_tmc13_tpu.models import geometry_obuf as jobuf
from mpeg_pcc_tmc13_tpu.models import geometry_octree as jgo
from mpeg_pcc_tmc13_tpu.models import pointcloud as jpc
from mpeg_pcc_tmc13_tpu.ops import octree as jops
from mpeg_pcc_tmc13_tpu.runtime import decoder as jdec
from mpeg_pcc_tmc13_tpu.runtime import encoder as jenc
from mpeg_pcc_tmc13_tpu_torch.bitstream import entropy as tentropy
from mpeg_pcc_tmc13_tpu_torch.bitstream import hls as thls
from mpeg_pcc_tmc13_tpu_torch.bitstream import tlv as ttlv
from mpeg_pcc_tmc13_tpu_torch.models import geometry_obuf as tobuf
from mpeg_pcc_tmc13_tpu_torch.models import geometry_octree as tgo
from mpeg_pcc_tmc13_tpu_torch.models import pointcloud as tpc
from mpeg_pcc_tmc13_tpu_torch.ops import octree as tops
from mpeg_pcc_tmc13_tpu_torch.runtime import decoder as tdec
from mpeg_pcc_tmc13_tpu_torch.runtime import encoder as tenc

torch.set_num_threads(2)

ENGINES = ("auto", "device", "rans", "obuf")
DAMAGES = ("lost_attribute_bricks", "flipped_geometry_bytes",
           "truncated_stream")
# (encoder, decoder, tlv, hls, pointcloud module, extra encoder/decoder
# arguments) of each package
JAX = (jenc, jdec, jtlv, jhls, jpc, {})
PORT = (tenc, tdec, ttlv, thls, tpc, {"device": "cpu"})


def _cloud(pc):
    """2,000 random points at depth 9 with colours and reflectance."""
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 1 << 9, size=(2000, 3), dtype=np.int64)
    colors = rng.integers(0, 256, (2000, 3)).astype(np.uint16)
    refl = rng.integers(0, 256, 2000).astype(np.uint16)
    return pc.PointCloud(pos, colors, refl)


def _encode(pkg, engine):
    enc, _, _, hls, pc, kw = pkg
    params = enc.EncoderParams(engine=engine, attributes=[
        enc.AttributeConfig("color", 8, hls.AttributeEncoding.RAHT, qp=22),
        enc.AttributeConfig("reflectance", 8, hls.AttributeEncoding.PRED,
                            qp=4)], **kw)
    bufs = []
    enc.FrameEncoder(params).compress(_cloud(pc), bufs.append)
    return bufs


@pytest.fixture(scope="module")
def streams():
    """Each engine's payloads from each package, encoded once."""
    cache = {}

    def get(engine):
        if engine not in cache:
            cache[engine] = (_encode(JAX, engine), _encode(PORT, engine))
        return cache[engine]
    return get


def _damaged(pkg, bufs, damage):
    """The payload buffers a decoder receives after ``damage``; the
    truncated stream is read from TLV bytes cut in half (the cut raises
    where ``iter_tlv`` meets it)."""
    tlv = pkg[2]
    if damage == "lost_attribute_bricks":
        return [b for b in bufs if b.type != tlv.PayloadType.ATTRIBUTE_BRICK]
    if damage == "flipped_geometry_bytes":
        out = []
        for b in bufs:
            if b.type == tlv.PayloadType.GEOMETRY_BRICK:
                data = bytearray(b.data)
                mid = len(data) // 2
                for i in range(mid, min(mid + 16, len(data))):
                    data[i] ^= 0xA5
                b = tlv.PayloadBuffer(b.type, bytes(data))
            out.append(b)
        return out
    bs = io.BytesIO()
    for b in bufs:
        tlv.write_tlv(b, bs)
    data = bs.getvalue()
    return tlv.iter_tlv(io.BytesIO(data[:len(data) // 2]))


def _decode(pkg, bufs):
    """(exception type names in the order raised, decoded frames as
    (positions, colours, reflectances)).  A failed unit is recorded and
    decoding goes on with the next, as a resilient receiver would."""
    _, dec_mod, _, _, _, kw = pkg
    outs, errors = [], []
    dec = dec_mod.FrameDecoder(outs.append, **kw)
    it = iter(bufs)
    while True:
        try:
            b = next(it)
        except StopIteration:
            break
        except Exception as e:       # the TLV reader at the cut
            errors.append(type(e).__name__)
            break
        try:
            dec.decompress(b)
        except Exception as e:
            errors.append(type(e).__name__)
    try:
        dec.flush()
    except Exception as e:
        errors.append(type(e).__name__)
    return errors, [(o.positions, o.colors, o.reflectances) for o in outs]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("damage", DAMAGES)
def test_damaged_stream_decodes_as_jax(streams, damage, engine):
    jbufs, tbufs = streams(engine)
    assert [(b.type, b.data) for b in tbufs] == [(b.type, b.data)
                                                for b in jbufs]
    jerr, jframes = _decode(JAX, _damaged(JAX, jbufs, damage))
    terr, tframes = _decode(PORT, _damaged(PORT, tbufs, damage))
    assert terr == jerr
    assert len(tframes) == len(jframes)
    for t, j in zip(tframes, jframes):
        for a, b in zip(t, j):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(np.asarray(a), np.asarray(b))
    if damage == "lost_attribute_bricks":
        # every attribute falls back to its default, geometry intact
        (pos, colors, refl), = tframes
        assert pos.shape[0] == np.unique(_cloud(tpc).positions,
                                         axis=0).shape[0]
        assert np.all(refl == 128)


def _outcome(fn):
    """fn()'s result, or the name of the exception it raised."""
    try:
        return fn()
    except Exception as e:
        return type(e).__name__


def _same(a, b):
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", range(5))
def test_octree_decode_random_bytes_as_jax(seed):
    """Random bytes into the octree decoder (PARENT contexts): the same
    points, or the same capacity error."""
    data = np.random.default_rng(seed).integers(
        0, 256, 2000, dtype=np.uint8).tobytes()
    got = [_outcome(lambda: go.decode(
        5000, 8, ent.RangeDecoder(data), go.OctreeContexts(),
        ctx_mode=ops.CTX_MODE_PARENT))
        for ent, go, ops in ((tentropy, tgo, tops), (jentropy, jgo, jops))]
    assert _same(*got)
    assert isinstance(got[0], str) or got[0].shape[0] <= 8 ** 8


@pytest.mark.parametrize("seed", range(3))
def test_residual_decode_random_bytes_as_jax(seed):
    """Random bytes into the residual decoders: the same values."""
    data = np.random.default_rng(seed + 10).integers(
        0, 256, 500, dtype=np.uint8).tobytes()
    outs = []
    for ent in (tentropy, jentropy):
        dec = ent.RangeDecoder(data)
        ctx = ent.new_contexts(32)
        outs.append((dec.resbl(ctx, 1000), dec.residuals(ctx, 500, 3, 2)))
    (t1, t2), (j1, j2) = outs
    assert t1.shape == (1000,) and t2.shape == (500,)
    assert np.array_equal(t1, j1) and np.array_equal(t2, j2)


@pytest.mark.parametrize("frac", (0.75, 0.5, 0.25, 0.05))
def test_obuf_truncated_payload_as_jax(frac):
    """A cut OBUF payload: the same bounded point set, or the same
    error."""
    pos = np.unique(np.random.default_rng(1).integers(
        0, 128, (3000, 3)).astype(np.int64), axis=0)
    got = []
    for obuf, hls in ((tobuf, thls), (jobuf, jhls)):
        gps = hls.GeometryParameterSet(planar_mode_enabled=True)
        payload = obuf.encode(pos, 7, None, gps)
        cut = payload[:int(len(payload) * frac)]
        got.append(_outcome(lambda: obuf.decode(cut, pos.shape[0], 7, None,
                                                gps)))
    assert _same(*got)
    assert isinstance(got[0], str) or got[0].shape[0] <= pos.shape[0]
