"""The colour brick's float predicted RAHT on the card
(``ops/raht_float_device.py``), driven here on the CPU through its plain
versions: the card's orchestration (plan, truth pass, a prediction and
an inverse a level, the host quantiser between them) must give the
bytes and decoded values of the JAX package's ``models/attr_raht`` (the
reference) and of the port's numpy path, brick for brick.

Small clouds (16 to ~1,000 points): last-component prediction on and
off, RDOQ zeroing rows, a chroma QP offset and per-layer QP deltas,
duplicate points, a one-level tree, one channel, non-default prediction
thresholds and weights.  ``attr.card_bricks`` counts the bricks the card
loop coded.  The kernels themselves run only on a card (the test marked
``cuda``)."""

import dataclasses
import enum

import numpy as np
import pytest
import torch

from mpeg_pcc_tmc13_tpu.bitstream import hls as jhls
from mpeg_pcc_tmc13_tpu.models import attr_raht as jraht
from mpeg_pcc_tmc13_tpu.models import attributes as jattr
from mpeg_pcc_tmc13_tpu.ops import raht as jraht_ops
from mpeg_pcc_tmc13_tpu_torch.bitstream import hls
from mpeg_pcc_tmc13_tpu_torch.models import attr_raht, attributes
from mpeg_pcc_tmc13_tpu_torch.ops import _kernels
from mpeg_pcc_tmc13_tpu_torch.ops import raht_float_device as rfd
from mpeg_pcc_tmc13_tpu_torch.runtime import decoder as decoder_mod
from mpeg_pcc_tmc13_tpu_torch.runtime import encoder as encoder_mod
from mpeg_pcc_tmc13_tpu_torch.utils import morton, timing

torch.set_num_threads(2)

CPU = torch.device("cpu")


class _Sink:
    def __init__(self):
        self.spans, self.counters = {}, {}


def _surface(n_side, seed, dups=0, extent=None):
    """A wavy height field of n_side x n_side/4 cells with smooth,
    correlated RGB plus noise; ``dups`` points repeated with other
    colours; ``extent``: positions folded into a cube of that side."""
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.arange(n_side), np.arange(max(n_side // 4, 2)),
                       indexing="ij")
    z = np.round(12 + 6 * np.sin(x / 7 + rng.uniform(0, 6))
                 * np.cos(y / 4)).astype(np.int64)
    pos = np.stack([x, y, z], -1).reshape(-1, 3)
    if extent is not None:
        pos = pos % extent
    field = (np.sin(pos[:, 0] / 5 + rng.uniform(0, 6))
             + np.cos(pos[:, 1] / 3))[:, None]
    rgb = (rng.integers(60, 190, 3) + 45 * field * np.array([1, .7, -.4])
           + rng.normal(0, 4, (pos.shape[0], 3)))
    if dups:
        at = rng.choice(pos.shape[0], dups, replace=False)
        pos = np.concatenate([pos, pos[at]])
        rgb = np.concatenate([rgb, rgb[at] + rng.normal(0, 20, (dups, 3))])
    order = np.argsort(morton.encode(pos), kind="stable")
    return pos[order], np.clip(np.round(rgb), 0, 255).astype(np.int64)[order]


def _brick(pos, vals, aps, desc, abh, card):
    """Encode and decode one attribute brick (header written and parsed
    as the frame codec does); ``card``: through the card orchestration
    on the CPU.  Returns (bytes, decoded, encode counters, decode
    counters)."""
    device = CPU if card else None
    sinks = _Sink(), _Sink()
    with timing.tracing(sinks[0]):
        body = attributes.encode(vals, pos, aps, desc,
                                 attributes.AttributeContexts(), abh=abh,
                                 device=device)
    data = abh.write() + body
    h, off = hls.AttributeBrickHeader.parse(data)
    with timing.tracing(sinks[1]):
        out = attributes.decode(data[off:], pos, aps, desc,
                                attributes.AttributeContexts(), abh=h,
                                device=device)
    return data, np.asarray(out), sinks[0].counters, sinks[1].counters


def _jax(obj):
    """The JAX package's counterpart of a port hls object (the same
    field values), so the reference codes with objects of its own."""
    def conv(v):
        if isinstance(v, enum.IntEnum):
            return getattr(jhls, type(v).__name__)(int(v))
        return v
    return getattr(jhls, type(obj).__name__)(**{
        f.name: conv(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def _jax_brick(pos, vals, aps, desc, abh):
    """The reference's bytes and decoded values for one brick: the JAX
    package's ``models/attributes`` encode and decode, header written
    and parsed as the frame codec does."""
    jabh = _jax(abh)
    body = jattr.encode(vals, pos, _jax(aps), _jax(desc),
                        jattr.AttributeContexts(), abh=jabh)
    data = jabh.write() + body
    h, off = jhls.AttributeBrickHeader.parse(data)
    out = jattr.decode(data[off:], pos, _jax(aps), _jax(desc),
                       jattr.AttributeContexts(), abh=h)
    return data, np.asarray(out)


def _aps(**kw):
    base = dict(init_qp=34, chroma_qp_offset=-2, raht_fixed_point=True,
                last_component_prediction_enabled=True)
    base.update(kw)
    return hls.AttributeParameterSet(**base)


CASES = {
    # the CLI's defaults at r04: LCP, RDOQ, chroma offset
    "lcp": dict(n_side=64, aps=_aps()),
    "lcp_fine_qp": dict(n_side=48, aps=_aps(init_qp=22)),
    # LCP off takes the float transform with fixed point off
    "lcp_off": dict(n_side=64,
                    aps=_aps(last_component_prediction_enabled=False,
                             raht_fixed_point=False),
                    no_native=True),
    "layer_qp_deltas": dict(n_side=64, aps=_aps(),
                            layers=([3, -2, 1, 0, 4], [-1, 2, 0, 3, -3])),
    "duplicates": dict(n_side=48, aps=_aps(), dups=150),
    "one_level": dict(n_side=8, aps=_aps(), extent=2),
    "thresholds_weights": dict(n_side=64,
                               aps=_aps(raht_pred_threshold0=1,
                                        raht_pred_threshold1=3,
                                        raht_pred_weights=(4, 2, 1))),
    "reflectance": dict(n_side=64, aps=_aps(raht_fixed_point=False),
                        ncomp=1, layers=([2, -1], [0, 0])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_card_loop_gives_the_numpy_bytes_and_values(case, monkeypatch):
    c = CASES[case]
    pos, rgb = _surface(c["n_side"], seed=len(case), dups=c.get("dups", 0),
                        extent=c.get("extent"))
    ncomp = c.get("ncomp", 3)
    vals = rgb if ncomp == 3 else rgb[:, 0]
    desc = hls.AttributeDescription(
        label="color" if ncomp == 3 else "reflectance",
        num_components=ncomp)
    if c.get("no_native"):
        for m in (attr_raht, jraht):
            monkeypatch.setattr(m, "_native_fastpath_ok", lambda *a: False)
    zeroed = []
    rdoq = attr_raht._rdoq_zero_rows

    def spy(*a):
        flag, train = rdoq(*a)
        zeroed.append(int(flag.sum()))
        return flag, train

    monkeypatch.setattr(attr_raht, "_rdoq_zero_rows", spy)
    luma, chroma = c.get("layers", ([], []))

    def abh():
        return hls.AttributeBrickHeader(layer_qp_deltas_luma=list(luma),
                                        layer_qp_deltas_chroma=list(chroma))

    runs = [_brick(pos, vals, c["aps"], desc, abh(), card)
            for card in (False, True)]
    (b0, d0, e0, x0), (b1, d1, e1, x1) = runs
    bj, dj = _jax_brick(pos, vals, c["aps"], desc, abh())
    assert b1 == bj
    np.testing.assert_array_equal(d1, dj)
    assert b1 == b0
    np.testing.assert_array_equal(d1, d0)
    assert d0.shape[0] == pos.shape[0]
    for counters, want in ((e0, 0), (x0, 0), (e1, 1), (x1, 1)):
        assert counters["attr.card_bricks"] == want
        assert counters["attr.native_bricks"] == 0
    if case == "one_level":
        assert int(morton.encode(pos).max()) < 8
    if case == "lcp":
        assert sum(zeroed) > 0       # RDOQ zeroed rows on both paths


@pytest.mark.parametrize("step", [1.0, 8.0, 40.0])
def test_residuals_and_reconstruction_are_numpys_bit_for_bit(step):
    """The plain loop hands the quantiser the residuals of the JAX
    package's ``ops/raht.forward_predicted`` (and of the port's numpy
    copy) bit for bit, layer by layer, and decodes the reconstruction of
    its ``inverse_predicted`` bit for bit before rounding (a quantiser's
    deadzone would hide an ulp)."""
    from mpeg_pcc_tmc13_tpu_torch.ops import raht as raht_ops
    pos, rgb = _surface(40, seed=int(step), dups=0)
    codes = np.unique(morton.encode(pos))
    rgb = rgb[:codes.size]
    depth = attr_raht._tree_depth(codes)
    seen = {}
    for name in ("jax", "numpy", "card"):
        rows = seen[name] = []

        def quant(arr, tag):
            rows.append(arr.copy())
            return np.round(arr / step)

        def dequant(q, tag):
            return q * step

        if name == "jax":
            jraht_ops.forward_predicted(codes, rgb, depth, quant, dequant)
        elif name == "numpy":
            raht_ops.forward_predicted(codes, rgb, depth, quant, dequant)
        else:
            rfd.encode(codes, rgb, depth, quant, dequant, (2, 6), (9, 3, 1),
                       CPU)
    assert len(seen["card"]) == len(seen["jax"]) == 1 + 3 * depth
    assert len(seen["numpy"]) == len(seen["jax"])
    for a, b, j in zip(seen["card"], seen["numpy"], seen["jax"]):
        np.testing.assert_array_equal(a, j)
        np.testing.assert_array_equal(b, j)
    qs = [np.round(r / step) for r in seen["jax"]]
    recon = []
    for decode in (jraht_ops.inverse_predicted, raht_ops.inverse_predicted,
                   None):
        it = iter(qs)
        if decode is None:
            recon.append(rfd.decode(codes, depth, lambda n, t: next(it),
                                    lambda q, t: q * step, 3, (2, 6),
                                    (9, 3, 1), CPU))
        else:
            recon.append(decode(codes, depth, lambda n, t: next(it),
                                lambda q, t: q * step, 3))
    np.testing.assert_array_equal(recon[2], recon[0])
    np.testing.assert_array_equal(recon[1], recon[0])


def test_native_bricks_do_not_count_as_card_bricks():
    """LCP off and no layer deltas: the native engine codes the brick,
    whatever the device, and the card loop never runs."""
    pos, rgb = _surface(48, seed=5)
    aps = _aps(last_component_prediction_enabled=False,
               raht_fixed_point=False)
    _, _, enc, dec = _brick(pos, rgb, aps, hls.AttributeDescription(),
                            hls.AttributeBrickHeader(), True)
    assert enc["attr.card_bricks"] == 0 and dec["attr.card_bricks"] == 0
    assert enc["attr.native_bricks"] == 1


def test_plain_loop_launches_nothing():
    """The plain versions count no launch (nor does the plan's plain
    version), and the quantiser sees the root, then three layers a
    level, coarsest first, every coded row once."""
    pos, rgb = _surface(32, seed=2)
    codes = morton.encode(pos)
    depth = attr_raht._tree_depth(codes)
    _kernels.reset_launch_counts()
    layers = []

    def quant(arr, tag):
        layers.append((tag, arr.shape))
        return np.round(arr)

    rfd.encode(codes, rgb, depth, quant, lambda q, tag: q, (2, 6),
               (9, 3, 1), CPU)
    assert all(v == 0 for v in _kernels.LAUNCHES.values())
    assert [t for t, _ in layers] == [-1] + [g for g in range(depth)
                                             for _ in range(3)]
    assert sum(s[0] for _, s in layers) == codes.size


def test_float_loop_imports_nothing_of_the_fixed_point_codec():
    """The float loop takes the plan and its format from
    ``ops/raht_plan.py`` alone: ``ops/raht_float_device.py`` imports
    nothing of ``ops/raht_fp_device.py``."""
    import ast
    tree = ast.parse(open(rfd.__file__).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
            names.update(f"{node.module or ''}.{a.name}" for a in node.names)
    assert names and not any("raht_fp_device" in n for n in names), names


@pytest.mark.parametrize("engine", ["device", "native"])
def test_frame_codec_hands_the_engines_device_to_the_brick(engine,
                                                           monkeypatch):
    """``FrameEncoder`` and ``FrameDecoder`` hand the colour brick the
    card by one rule, ``cuda_or_none(--device)``, whatever the geometry
    engine: a host engine's slice takes the card loop too.  Here every
    device reads as a card, and the card loop runs on the plain
    versions."""
    from mpeg_pcc_tmc13_tpu_torch.models.pointcloud import PointCloud
    from mpeg_pcc_tmc13_tpu_torch.runtime import cli
    monkeypatch.setattr(encoder_mod, "cuda_or_none", lambda d: CPU)
    monkeypatch.setattr(decoder_mod, "cuda_or_none", lambda d: CPU)
    pos, rgb = _surface(48, seed=9)
    cfg = cli.parse_command_line([
        "--mode=0", "--qp=34", "--qpChromaOffset=-2", "--attribute=color",
        f"--geomEngine={engine}", "--device=cpu"])
    units, sinks = [], (_Sink(), _Sink())
    with timing.tracing(sinks[0], "encode"):
        enc = encoder_mod.FrameEncoder(cfg.params)
        enc.compress(PointCloud(pos, rgb, None), units.append)
        enc.flush(units.append)
    frames = []
    with timing.tracing(sinks[1], "decode"):
        dec = decoder_mod.FrameDecoder(frames.append, device="cpu")
        for u in units:
            dec.decompress(u)
        dec.flush()
    assert sinks[0].counters["encode.attr.card_bricks"] == 1
    assert sinks[1].counters["decode.attr.card_bricks"] == 1
    assert frames[0].count == np.unique(morton.encode(pos)).size


@pytest.mark.cuda
def test_kernels_equal_their_plain_versions_and_numpy():
    """The card loop through the kernels and through the plain versions,
    both on the card, and numpy's loop: the same residual rows, layer by
    layer, bit for bit."""
    from mpeg_pcc_tmc13_tpu_torch.ops import raht as raht_ops
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    dev = torch.device("cuda")
    pos, rgb = _surface(96, seed=4)
    codes = np.unique(morton.encode(pos))
    rgb = rgb[:codes.size]
    depth = attr_raht._tree_depth(codes)
    rows = {}
    for name in ("cuda", "plain", "numpy"):
        seen = rows[name] = []

        def quant(arr, tag):
            seen.append(arr.copy())
            return np.round(arr / 8.0)

        def dequant(q, tag):
            return 8.0 * q

        if name == "numpy":
            raht_ops.forward_predicted(codes, rgb, depth, quant, dequant)
        else:
            rfd.encode(codes, rgb, depth, quant, dequant, (2, 6), (9, 3, 1),
                       dev, rfd.CUDA_LAUNCHERS if name == "cuda"
                       else rfd.PLAIN_LAUNCHERS)
    assert len(rows["cuda"]) == 1 + 3 * depth
    for a, b, c in zip(rows["cuda"], rows["plain"], rows["numpy"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
