"""RAHT attribute codec: transform + quantise + residual entropy coding.

Counterpart of the reference `regionAdaptiveHierarchicalTransform[Inverse]`
(RAHT.cpp:1998,2038) + the coefficient coder in AttributeEncoder.cpp.
Transform structure is geometry-derived on both sides (ops/raht.py), so
the payload is just the quantised coefficients: per component, a
zero-run + sign + ueg residual stream (bitstream/entropy.py residuals).

QP -> stepsize follows the reference's 6-QP-per-octave law
(quantization.cpp:46-53): step = 2**((qp-4)/6), fixed-point Q16.
qp==4 is step 1; with the integer-Haar transform that is exactly
lossless.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import entropy
from ..bitstream.hls import (AttributeDescription,
                                              AttributeParameterSet)
from ..ops import raht as raht_ops

from ..utils import morton, timing
from .attributes import AttributeContexts, RES_CTX_SIZE, ZRUN_CTX_SIZE, \
    _RES_PREFIX_MAX, _RES_K


def qp_to_step_q16(qp: int) -> int:
    return max(1, int(round((2.0 ** ((qp - 4) / 6.0)) * 65536)))


def _quantize(c: np.ndarray, step_q16: int) -> np.ndarray:
    """Deadzone quantiser: |q| = floor(|c|/step + 1/3), matching the
    reference's forward offset (quantization.h:80-94) — values under
    2/3 of a step quantise to zero, which is what keeps near-zero
    prediction residuals free."""
    if c.dtype == np.int64 and step_q16 == 65536:
        return c.astype(np.int64)
    s = c.astype(np.float64) * 65536.0 / step_q16
    q = np.sign(s) * np.floor(np.abs(s) + (1.0 / 3.0))
    return q.astype(np.int64)


def _dequantize(q: np.ndarray, step_q16: int, integer: bool) -> np.ndarray:
    if integer and step_q16 == 65536:
        return q.astype(np.int64)
    d = q.astype(np.float64) * step_q16 / 65536.0
    return np.round(d).astype(np.int64) if integer else d


def _tree_depth(codes: np.ndarray) -> int:
    hi = int(codes.max()) if codes.size else 0
    return max((hi.bit_length() + 2) // 3, 1)


def _unique_and_inverse(codes: np.ndarray):
    """codes sorted (may contain dups) -> (unique, inverse_map)."""
    keep = np.concatenate([[True], codes[1:] != codes[:-1]]) \
        if codes.size else np.zeros(0, bool)
    inv = np.cumsum(keep) - 1
    return codes[keep], inv, keep


def _steps(aps, ncomp, abh=None):
    return [qp_to_step_q16(max(aps.init_qp
                               + (aps.chroma_qp_offset if c > 0 else 0)
                               + (abh.layer_qp_offset(c, 0)
                                  if abh is not None else 0),
                               4)) for c in range(ncomp)]


def step_q16_vec(qp: np.ndarray) -> np.ndarray:
    """Vectorised QP -> Q16 stepsize (per-point region QPs)."""
    q = np.maximum(np.asarray(qp, dtype=np.float64), 4.0)
    return np.maximum(
        1, np.round((2.0 ** ((q - 4.0) / 6.0)) * 65536.0)).astype(np.int64)


def _step_fn(aps, abh):
    """(component, layer) -> step_q16 with ABH slice/layer QP deltas
    (reference deriveQps, AttributeCommon.cpp).  fn.qp exposes the QP
    itself for per-point region offsets."""
    base = [aps.init_qp + (aps.chroma_qp_offset if c > 0 else 0)
            for c in range(3)]

    def qp(c, layer):
        q = base[min(c, 2)]
        if abh is not None:
            q += abh.layer_qp_offset(c, layer)
        return q

    def fn(c, layer):
        return qp_to_step_q16(max(qp(c, layer), 4))
    fn.qp = qp
    return fn


# ---- RDOQ (encoder-side only) ---------------------------------------
# Reference RAHT.cpp:1560-1663: a coefficient row (all components of
# one AC position) is zeroed when its rate — estimated from the
# current zero-run length and a log2 magnitude LUT — costs more than
# lambda = step_luma^2 * (25|35) buys in distortion.  This is what
# keeps isolated just-above-deadzone residuals from being coded.
_LUTLOG = np.array([0, 256, 406, 512, 594, 662, 719, 768, 812, 850,
                    886, 918, 947, 975, 1000, 1024], dtype=np.int64)
_LUTBINS = np.array([1, 2, 3, 5, 5, 7, 7, 9, 9, 11, 11], dtype=np.int64)


def _rdoq_zero_rows(arr: np.ndarray, steps_q16, train_in: int):
    """Returns (zero_mask, train_out) for coefficient rows arr (M, C)
    in sample units.  Mirrors the reference decision with the zero-run
    (trainZeros) approximated by the runs of naturally-zero rows."""
    m, ncomp = arr.shape
    if m == 0:
        return np.zeros(0, dtype=bool), train_in
    aq = np.empty((m, ncomp), dtype=np.int64)
    for c in range(ncomp):
        s = np.abs(arr[:, c]) * 65536.0 / steps_q16[c]
        aq[:, c] = np.floor(s + (1.0 / 3.0)).astype(np.int64)
    sumc = aq.sum(axis=1)
    dist2 = (arr.astype(np.float64) ** 2).sum(axis=1)
    ratec = _LUTLOG[np.minimum(aq, 15)].sum(axis=1)

    step_luma = steps_q16[0] / 65536.0
    mult = 25.0 if ncomp == 1 else 35.0
    lam = step_luma * step_luma * mult
    idx = np.arange(m, dtype=np.int64)
    extra = (ratec + 128) >> 8

    # The reference's trainZeros counts RDOQ-zeroed rows too, so each
    # zeroing lengthens runs and raises the rate estimate for the next
    # candidate — a cascade.  Iterate the vectorised decision to its
    # (monotone) fixpoint.
    flag = np.zeros(m, dtype=bool)
    for _ in range(4):
        z = (sumc == 0) | flag
        last_nz = np.maximum.accumulate(np.where(~z, idx, np.int64(-1)))
        last_nz_before = np.concatenate([[-1], last_nz[:-1]])
        train = idx - 1 - last_nz_before
        train[last_nz_before == -1] += train_in + 1
        rate = _LUTBINS[np.minimum(train, 10)].copy()
        long_run = train > 10
        if long_run.any():
            t = (train[long_run] - 10).astype(np.float64)
            a = np.frexp(t)[1].astype(np.int64)  # bit length
            rate[long_run] += 2 * a - 1 + 2
        rate += extra
        new_flag = (sumc > 0) & (sumc < 3) \
            & (dist2 * 1024.0 < lam * rate.astype(np.float64))
        if (new_flag == flag).all():
            break
        flag = new_flag
    zeroed = (sumc == 0) | flag
    if zeroed.all():
        train_out = train_in + m
    else:
        train_out = m - 1 - int(np.flatnonzero(~zeroed)[-1])
    return flag, train_out


def _lcp_estimate(c1: np.ndarray, c2: np.ndarray) -> int:
    """Per-layer last-component prediction coefficient (reference
    computeLastComponentPredictionCoeff, AttributeEncoder.cpp:1499):
    least-squares c2 ~ (k/4) * c1, k clipped to [-8, 8]."""
    s11 = float(np.dot(c1.astype(np.float64), c1.astype(np.float64)))
    if s11 <= 0.0:
        return 0
    s12 = float(np.dot(c1.astype(np.float64), c2.astype(np.float64)))
    return int(np.clip(round(4.0 * s12 / s11), -8, 8))


def _lcp_pred(k: int, dq1: np.ndarray, integer: bool) -> np.ndarray:
    if integer:
        return (np.int64(k) * dq1.astype(np.int64)) >> 2
    return k * dq1 / 4.0


def _native_fastpath_ok(coder, aps, abh, haar, ncomp, steps) -> bool:
    """True when the predicted-RAHT brick can run entirely in
    native/attr_raht.cc: the common configuration (float transform,
    prediction on, no LCP, no per-layer QP deltas) with the native
    range coder.  The numpy path stays the spec for everything else;
    the native engine emits byte-identical streams (tested)."""
    if entropy._LIB is None or not hasattr(coder, "_h"):
        return False
    if haar or ncomp < 1 or ncomp > 3:
        return False
    if aps.last_component_prediction_enabled and ncomp == 3 \
            and abh is not None:
        return False
    if abh is not None and (abh.layer_qp_deltas_luma
                            or abh.layer_qp_deltas_chroma):
        return False
    return all(1 <= s < (1 << 31) for s in steps)


def _open_counters():
    """A brick's counters at 0, so that a traced run records all four
    whichever path codes the brick: ``attr.entropy_s`` (seconds in the
    residual and zrow coder), ``attr.lcp_layers`` (layers whose
    last-component prediction coefficient is non-zero),
    ``attr.native_bricks`` (bricks coded by native/attr_raht.cc) and
    ``attr.card_bricks`` (bricks whose float predicted RAHT ran the card
    loop, ops/raht_float_device.py)."""
    for name in ("attr.entropy_s", "attr.lcp_layers", "attr.native_bricks",
                 "attr.card_bricks"):
        timing.count(name, 0)


def _ref_pyramid(ref, aps, depth, haar):
    if ref is None or not aps.inter_prediction_enabled \
            or not aps.raht_prediction_enabled or not len(ref[0]):
        return None
    from ..ops.raht import ref_mean_pyramid
    return ref_mean_pyramid(
        morton.encode(np.asarray(ref[0], dtype=np.int64)),
        ref[1], depth, haar)


def encode(values: np.ndarray, positions: np.ndarray,
           aps: AttributeParameterSet, desc: AttributeDescription,
           ctx: AttributeContexts, ref=None, abh=None,
           device=None) -> bytes:
    """One RAHT attribute brick.  ``device``: where a float predicted
    brick that the native engine refuses (LCP on, per-layer QP deltas)
    runs its transform and prediction (ops/raht_float_device.py: the
    kernels on a CUDA device, their plain versions elsewhere), the
    quantiser and coder staying on the host, the same bytes; None:
    numpy's ops/raht.py."""
    _open_counters()
    codes = morton.encode(positions.astype(np.int64))
    uniq, inv, keep = _unique_and_inverse(codes)
    vals = np.asarray(values)
    if vals.ndim == 1:
        vals = vals[:, None]
    if uniq.size != codes.size:
        # duplicates: mean-reduce (reference reduceUnique, RAHT.cpp:300)
        sums = np.zeros((uniq.size, vals.shape[1]), dtype=np.int64)
        np.add.at(sums, inv, vals.astype(np.int64))
        counts = np.bincount(inv)[:, None]
        uvals = (sums + counts // 2) // counts
    else:
        uvals = vals.astype(np.int64)
    depth = _tree_depth(uniq)
    haar = aps.raht_integer_haar
    ncomp = uvals.shape[1]
    steps = _steps(aps, ncomp, abh)
    step_at = _step_fn(aps, abh)
    enc = entropy.RangeEncoder()

    lcp_on = (aps.last_component_prediction_enabled and ncomp == 3
              and abh is not None)

    rdoq_state = {"train": 0}

    def _apply_rdoq(arr, tag):
        if haar or tag < 0:
            return arr
        flag, rdoq_state["train"] = _rdoq_zero_rows(
            arr, [step_at(c, tag) for c in range(ncomp)],
            rdoq_state["train"])
        if flag.any():
            arr = arr.copy()
            arr[flag] = 0
        return arr

    if (aps.raht_fixed_point and aps.raht_prediction_enabled
            and not haar and uniq.size > 1
            and _ref_pyramid(ref, aps, depth, haar) is None
            and not lcp_on):
        # fixed-point mode (ops/raht_fp.py): deterministic integers,
        # identical streams from numpy / native C++ / device kernels
        from ..ops import raht_fp

        def emit(q, tag):
            with timing.counted("attr.entropy_s"):
                enc.zrow_residuals(ctx.zrow, q.astype(np.int32))

        if _native_fastpath_ok(enc, aps, abh, haar, ncomp, steps) \
                and hasattr(entropy._LIB, "raht_encode_fp"):
            import ctypes as _ct
            t0, t1 = aps.raht_pred_threshold0, aps.raht_pred_threshold1
            ws, wf, we = aps.raht_pred_weights
            codes_c = np.ascontiguousarray(uniq, dtype=np.int64)
            vals_c = np.ascontiguousarray(uvals, dtype=np.int64)
            steps_c = np.asarray(steps, dtype=np.int32)
            rc = entropy._LIB.raht_encode_fp(
                enc._h, entropy._ptr(ctx.zrow, _ct.c_uint16),
                entropy._ptr(codes_c, _ct.c_int64), uniq.size, depth,
                entropy._ptr(vals_c, _ct.c_int64), ncomp,
                entropy._ptr(steps_c, _ct.c_int32),
                t0, t1, ws, wf, we)
            if rc == 0:
                timing.count("attr.native_bricks", 1)
                return enc.get_bytes()
        raht_fp.forward_predicted_fp(
            uniq, uvals, depth, step_at,
            thresholds=(aps.raht_pred_threshold0,
                        aps.raht_pred_threshold1),
            weights=aps.raht_pred_weights, emit=emit)
        return enc.get_bytes()

    if aps.raht_prediction_enabled and uniq.size > 1:
        ref_pyr = _ref_pyramid(ref, aps, depth, haar)
        if ref_pyr is None and _native_fastpath_ok(
                enc, aps, abh, haar, ncomp, steps):
            import ctypes as _ct
            t0, t1 = aps.raht_pred_threshold0, aps.raht_pred_threshold1
            ws, wf, we = aps.raht_pred_weights
            codes_c = np.ascontiguousarray(uniq, dtype=np.int64)
            vals_c = np.ascontiguousarray(uvals, dtype=np.int64)
            steps_c = np.asarray(steps, dtype=np.int32)
            rc = entropy._LIB.raht_encode_predicted(
                enc._h, entropy._ptr(ctx.zrow, _ct.c_uint16),
                entropy._ptr(codes_c, _ct.c_int64), uniq.size, depth,
                entropy._ptr(vals_c, _ct.c_int64), ncomp,
                entropy._ptr(steps_c, _ct.c_int32),
                t0, t1, ws, wf, we)
            if rc == 0:
                timing.count("attr.native_bricks", 1)
                return enc.get_bytes()

        def quant(arr, tag):
            with timing.span("attr.quant"):
                arr = _apply_rdoq(arr, tag)
                cols = [_quantize(arr[:, c], step_at(c, tag))
                        for c in range(ncomp)]
                if lcp_on:
                    # chunk-order coefficient: subtract the predicted
                    # part of comp 2 before quantising
                    dq1 = _dequantize(cols[1], step_at(1, tag), haar)
                    k = _lcp_estimate(arr[:, 1], arr[:, 2])
                    abh.lcp_coeffs.append(k)
                    cols[2] = _quantize(
                        arr[:, 2] - _lcp_pred(k, dq1, haar),
                        step_at(2, tag))
                q = np.stack(cols, axis=1)
                with timing.counted("attr.entropy_s"):
                    enc.zrow_residuals(ctx.zrow, q.astype(np.int32))
                return q

        def dequant(q, tag):
            cols = [_dequantize(q[:, c], step_at(c, tag), haar)
                    for c in range(ncomp)]
            if lcp_on:
                cols[2] = cols[2] + _lcp_pred(abh.lcp_coeffs[-1],
                                              cols[1], haar)
            return np.stack(cols, axis=1)

        thresholds = (aps.raht_pred_threshold0, aps.raht_pred_threshold1)
        if device is not None and ref_pyr is None and not haar:
            from ..ops import raht_float_device
            raht_float_device.encode(uniq, uvals, depth, quant, dequant,
                                     thresholds, aps.raht_pred_weights,
                                     device)
            timing.count("attr.card_bricks", 1)
        else:
            raht_ops.forward_predicted(
                uniq, uvals, depth, quant, dequant, integer_haar=haar,
                ref_pyramid=ref_pyr, thresholds=thresholds,
                weights=aps.raht_pred_weights)
        if lcp_on:
            timing.count("attr.lcp_layers",
                         sum(k != 0 for k in abh.lcp_coeffs))
        return enc.get_bytes()

    coeffs = raht_ops.forward(uniq, uvals, depth, integer_haar=haar)
    if not haar and coeffs.shape[0] > 1:
        # RDOQ over the AC rows (the root DC row 0 is always kept)
        flag, _ = _rdoq_zero_rows(coeffs[1:], steps, 0)
        if flag.any():
            coeffs = coeffs.copy()
            coeffs[1:][flag] = 0
    q = np.stack([_quantize(coeffs[:, c], steps[c])
                  for c in range(ncomp)], axis=1)
    with timing.counted("attr.entropy_s"):
        enc.zrow_residuals(ctx.zrow, q.astype(np.int32))
    return enc.get_bytes()


def decode(data: bytes, positions: np.ndarray,
           aps: AttributeParameterSet, desc: AttributeDescription,
           ctx: AttributeContexts, ref=None, abh=None,
           device=None) -> np.ndarray:
    """Decode one RAHT attribute brick; ``device`` as ``encode``'s."""
    _open_counters()
    codes = morton.encode(positions.astype(np.int64))
    uniq, inv, keep = _unique_and_inverse(codes)
    depth = _tree_depth(uniq)
    haar = aps.raht_integer_haar
    n = uniq.size
    ncomp = desc.num_components
    steps = _steps(aps, ncomp, abh)
    step_at = _step_fn(aps, abh)
    dec = entropy.RangeDecoder(data)

    lcp_on = (aps.last_component_prediction_enabled and ncomp == 3
              and abh is not None and len(abh.lcp_coeffs) > 0)
    lcp_idx = [0]

    if (aps.raht_fixed_point and aps.raht_prediction_enabled
            and not haar and n > 1
            and _ref_pyramid(ref, aps, depth, haar) is None
            and not lcp_on):
        from ..ops import raht_fp
        if _native_fastpath_ok(dec, aps, abh, haar, ncomp, steps) \
                and hasattr(entropy._LIB, "raht_decode_fp"):
            import ctypes as _ct
            t0, t1 = aps.raht_pred_threshold0, aps.raht_pred_threshold1
            ws, wf, we = aps.raht_pred_weights
            codes_c = np.ascontiguousarray(uniq, dtype=np.int64)
            out_c = np.zeros((n, ncomp), dtype=np.int64)
            steps_c = np.asarray(steps, dtype=np.int32)
            rc = entropy._LIB.raht_decode_fp(
                dec._h, entropy._ptr(ctx.zrow, _ct.c_uint16),
                entropy._ptr(codes_c, _ct.c_int64), n, depth,
                entropy._ptr(out_c, _ct.c_int64), ncomp,
                entropy._ptr(steps_c, _ct.c_int32),
                t0, t1, ws, wf, we)
            if rc == 0:
                timing.count("attr.native_bricks", 1)
                out = out_c[inv]
                return out[:, 0] if ncomp == 1 else out

        def read_q_fp(count, tag):
            with timing.counted("attr.entropy_s"):
                return dec.zrow_residuals(ctx.zrow, count,
                                          ncomp).astype(np.int64)

        vals = raht_fp.inverse_predicted_fp(
            uniq, depth, read_q_fp, step_at, ncomp,
            thresholds=(aps.raht_pred_threshold0,
                        aps.raht_pred_threshold1),
            weights=aps.raht_pred_weights)
        out = vals[inv]
        return out[:, 0] if ncomp == 1 else out

    if aps.raht_prediction_enabled and n > 1:
        ref_pyr = _ref_pyramid(ref, aps, depth, haar)
        if ref_pyr is None and not lcp_on and _native_fastpath_ok(
                dec, aps, abh, haar, ncomp, steps):
            import ctypes as _ct
            t0, t1 = aps.raht_pred_threshold0, aps.raht_pred_threshold1
            ws, wf, we = aps.raht_pred_weights
            codes_c = np.ascontiguousarray(uniq, dtype=np.int64)
            out_c = np.zeros((n, ncomp), dtype=np.int64)
            steps_c = np.asarray(steps, dtype=np.int32)
            rc = entropy._LIB.raht_decode_predicted(
                dec._h, entropy._ptr(ctx.zrow, _ct.c_uint16),
                entropy._ptr(codes_c, _ct.c_int64), n, depth,
                entropy._ptr(out_c, _ct.c_int64), ncomp,
                entropy._ptr(steps_c, _ct.c_int32),
                t0, t1, ws, wf, we)
            if rc == 0:
                timing.count("attr.native_bricks", 1)
                out = out_c[inv]
                return out[:, 0] if ncomp == 1 else out

        def read_q(count, tag):
            with timing.counted("attr.entropy_s"):
                return dec.zrow_residuals(ctx.zrow, count,
                                          ncomp).astype(np.int64)

        def dequant(q, tag):
            cols = [_dequantize(q[:, c], step_at(c, tag), haar)
                    for c in range(ncomp)]
            if lcp_on:
                i = min(lcp_idx[0], len(abh.lcp_coeffs) - 1)
                lcp_idx[0] += 1
                cols[2] = cols[2] + _lcp_pred(abh.lcp_coeffs[i],
                                              cols[1], haar)
            return np.stack(cols, axis=1)

        if lcp_on:
            timing.count("attr.lcp_layers",
                         sum(k != 0 for k in abh.lcp_coeffs))
        thresholds = (aps.raht_pred_threshold0, aps.raht_pred_threshold1)
        if device is not None and ref_pyr is None and not haar:
            from ..ops import raht_float_device
            vals = raht_float_device.decode(uniq, depth, read_q, dequant,
                                            ncomp, thresholds,
                                            aps.raht_pred_weights, device)
            timing.count("attr.card_bricks", 1)
        else:
            vals = raht_ops.inverse_predicted(
                uniq, depth, read_q, dequant, ncomp, integer_haar=haar,
                ref_pyramid=ref_pyr, thresholds=thresholds,
                weights=aps.raht_pred_weights)
        if not haar:
            vals = np.round(vals).astype(np.int64)
        out = vals[inv]
        return out[:, 0] if ncomp == 1 else out

    with timing.counted("attr.entropy_s"):
        qrows = dec.zrow_residuals(ctx.zrow, n, ncomp).astype(np.int64)
    coeffs = np.stack([_dequantize(qrows[:, c], steps[c], haar)
                       for c in range(ncomp)], axis=1)
    vals = raht_ops.inverse(uniq, coeffs, depth, integer_haar=haar)
    if not haar:
        vals = np.round(vals).astype(np.int64)
    hi = (1 << desc.bitdepth) - 1
    # YCgCo-R chroma is signed (bitdepth+1); clip only the luma-like
    # range when unsigned storage is implied by the descriptor
    out = vals[inv]
    if ncomp == 1:
        return out[:, 0]
    return out
