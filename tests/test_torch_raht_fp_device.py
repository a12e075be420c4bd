"""Port parity: device fixed-point RAHT
(mpeg_pcc_tmc13_tpu_torch.ops.raht_fp_device) against the JAX device
codec and the numpy spec (mpeg_pcc_tmc13_tpu/ops/raht_fp.py).

All integer arithmetic, so quantised rows and decoded values must be
identical, row for row, to both references.
"""

import numpy as np
import pytest
import torch

from mpeg_pcc_tmc13_tpu.models import attr_raht as jattr
from mpeg_pcc_tmc13_tpu.ops import raht_fp
from mpeg_pcc_tmc13_tpu.ops import raht_fp_device as jfp
from mpeg_pcc_tmc13_tpu_torch.models import attr_raht as tattr
from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as tfp
from mpeg_pcc_tmc13_tpu_torch.utils import morton as tmorton

torch.set_num_threads(2)


def _cloud(n, extent, seed, ncomp=3):
    """The cloud of tests/test_raht_fp.py: Morton-sorted unique points
    with correlated integer attributes."""
    rng = np.random.default_rng(seed)
    pos = np.unique(rng.integers(0, extent, (n, 3)).astype(np.int64),
                    axis=0)
    pos = pos[np.argsort(tmorton.encode(pos), kind="stable")]
    base = (pos @ np.array([3, 5, 7]))[:, None]
    vals = ((base * np.arange(1, ncomp + 1)
             + rng.integers(0, 40, (pos.shape[0], ncomp))) % 256)
    return pos, vals.astype(np.int64)


def _spec(codes, vals, depth, steps):
    qs = []
    raht_fp.forward_predicted_fp(
        codes, vals, depth, lambda c, tag: steps[c],
        emit=lambda q, tag: qs.append(np.asarray(q, np.int32)))
    it = iter(qs)
    dec = raht_fp.inverse_predicted_fp(
        codes, depth, lambda m, tag: next(it).astype(np.int64),
        lambda c, tag: steps[c], vals.shape[1])
    return qs, dec


def _port(codes, vals, depth, steps, ref_qs):
    dv = tfp.DeviceFpRaht(codes, depth, steps, device="cpu")
    qs = []
    dv.encode(vals, qs.append)
    it = iter(ref_qs)
    dec = dv.decode(lambda m: next(it), vals.shape[1])
    assert dec.dtype == torch.int64
    return qs, dec.numpy()


def _same_rows(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.int32
        assert np.array_equal(x, y)


def test_q_stream_matches_jax_and_spec():
    """The case of tests/test_raht_fp.py::test_fp_device_q_stream_identity."""
    pos, vals = _cloud(4000, 64, 9)
    codes = tmorton.encode(pos)
    depth = 6
    steps = [13000, 17000, 17000]
    spec_qs, spec_dec = _spec(codes, vals, depth, steps)

    jax_qs = []
    jdv = jfp.DeviceFpRaht(codes, depth, steps)
    jdv.encode(vals, jax_qs.append)
    it = iter(spec_qs)
    jax_dec = np.asarray(jdv.decode(lambda m: next(it), 3))

    qs, dec = _port(codes, vals, depth, steps, spec_qs)
    _same_rows(qs, spec_qs)
    _same_rows(qs, jax_qs)
    assert np.array_equal(dec, spec_dec)
    assert np.array_equal(dec, jax_dec)


@pytest.mark.parametrize("ncomp,qp,extent", [(1, 30, 32), (3, 4, 16),
                                              (3, 40, 128)])
def test_q_stream_matches_spec(ncomp, qp, extent):
    pos, vals = _cloud(3000, extent, qp, ncomp=ncomp)
    codes = tmorton.encode(pos)
    depth = int(extent).bit_length() - 1
    steps = [tattr.qp_to_step_q16(qp)] * ncomp
    spec_qs, spec_dec = _spec(codes, vals, depth, steps)
    qs, dec = _port(codes, vals, depth, steps, spec_qs)
    _same_rows(qs, spec_qs)
    assert np.array_equal(dec, spec_dec)


def test_plans_to_torch_carries_host_plans():
    pos, _ = _cloud(1500, 32, 3)
    codes = tmorton.encode(pos)
    host = jfp.build_fp_plan(codes, 5)
    dev = tfp.plans_to_torch(host, "cpu")
    assert len(dev) == len(host)
    for hp, p in zip(host, dev):
        for k, t in p.items():
            ref = np.asarray(getattr(hp, k))
            assert t.dtype == (torch.bool if ref.dtype == bool
                               else torch.int64), k
            assert np.array_equal(t.numpy(), ref), k


def test_quant_dequant_match_spec():
    rng = np.random.default_rng(0)
    res = rng.integers(-(1 << 40), 1 << 40, (2000, 3), dtype=np.int64)
    res[:10] = 0
    steps = np.array([1, 13000, 1 << 20], dtype=np.int64)
    st = torch.as_tensor(steps)
    q = tfp._quant(torch.as_tensor(res), st)
    d = tfp._dequant(q, st)
    for c in range(3):
        ref_q = raht_fp.quant_fp(res[:, c], int(steps[c]))
        assert np.array_equal(q.numpy()[:, c], ref_q)
        assert np.array_equal(d.numpy()[:, c],
                              raht_fp.dequant_fp(ref_q, int(steps[c])))


@pytest.mark.parametrize("qp", [0, 4, 22, 34, 51])
def test_qp_to_step_matches_reference(qp):
    assert tattr.qp_to_step_q16(qp) == jattr.qp_to_step_q16(qp)
