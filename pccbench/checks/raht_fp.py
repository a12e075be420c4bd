"""The default attribute check: the fixed-point RAHT closed loop against
the plain reference (``reference/raht_fp.py``), one slice a frame.

Over every coding in the window of one frame drawn from the seed:

- ``attr_q_wrong``: the q entries the encoder emitted that differ from
  the reference encoder's (all of them where the counts differ);
- ``attr_recon_gap``: the largest gap between the encoder's
  reconstruction (Q13) and the reference encoder's;
- ``attr_decoded_gap``: the largest gap between the decoded values and
  the reference decoder's.

The reference rebuilds its own structure from the frame's codes and
codes the frame's values itself.  The numbers compare the exact
fixed-point closed loop that the configuration states
(``rahtFixedPoint=1``): limit 0 each.  The control
(``python3 -m pccbench.control``) is the same reference with every floor
division of values taken through a float32 quotient.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from pccbench.frames import step_q16
from pccbench.reference import raht_fp

LIMITS = {"attr_q_wrong": 0, "attr_recon_gap": 0, "attr_decoded_gap": 0}
# a gap where the shapes disagree: larger than any Q13 value of 8-bit data
SHAPE_GAP = float(1 << 40)


def outputs(e, values) -> dict:
    """What the reference judges of one coding: q rows, the encoder's
    reconstruction and the decoded values, as host arrays."""
    return {"q": np.concatenate(e.q_rows, axis=0) if e.q_rows else None,
            "recon": None if e.recon is None else e.recon.cpu().numpy(),
            "decoded": values}


def reference_attributes(codes: np.ndarray, values: np.ndarray, depth: int,
                         step: int, div=raht_fp.floordiv):
    """(q rows (M, C) in coded order, encoder reconstruction (N, C) Q13,
    decoded values (N, C)) of the reference, from the frame alone."""
    qs: List[np.ndarray] = []
    recon = raht_fp.forward_predicted_fp(
        codes, values, depth, lambda c, tag: step,
        emit=lambda q, tag: qs.append(np.asarray(q, np.int64)), div=div)
    it = iter(qs)
    decoded = raht_fp.inverse_predicted_fp(
        codes, depth, lambda m, tag: next(it), lambda c, tag: step,
        values.shape[1], div=div)
    return np.concatenate(qs, axis=0), recon, decoded


def reference(frame, cfg: dict):
    return reference_attributes(frame.codes, frame.values, int(cfg["bits"]),
                                step_q16(int(cfg["qp"])))


def float32_floordiv(a, b):
    """Floor of a float32 quotient, back to int64."""
    q = np.asarray(a, np.float32) / np.asarray(b, np.float32)
    return np.floor(q).astype(np.int64)


def controls(frame, cfg: dict) -> Dict[str, dict]:
    """Each control's outputs for the frame, as ``outputs`` gives the
    program's."""
    q, recon, decoded = reference_attributes(
        frame.codes, frame.values, int(cfg["bits"]),
        step_q16(int(cfg["qp"])), div=float32_floordiv)
    return {"control_float32": {"q": q, "recon": recon, "decoded": decoded}}


def _gap(a: Optional[np.ndarray], b: np.ndarray) -> float:
    if a is None or np.shape(a) != b.shape:
        return SHAPE_GAP
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(np.asarray(a, np.int64) - b)))


def q_wrong(q: Optional[np.ndarray], ref_q: np.ndarray) -> int:
    if q is None or q.shape != ref_q.shape:
        return int(max(ref_q.size, 0 if q is None else q.size))
    return int(np.count_nonzero(np.asarray(q, np.int64) != ref_q))


def numbers(kept: List[dict], ref) -> Dict[str, float]:
    """``kept``: per coding of the sampled frame, ``outputs``' dict."""
    ref_q, ref_recon, ref_dec = ref
    out = {"attr_q_wrong": 0, "attr_recon_gap": 0.0, "attr_decoded_gap": 0.0}
    for o in kept:
        out["attr_q_wrong"] += q_wrong(o["q"], ref_q)
        out["attr_recon_gap"] = max(out["attr_recon_gap"],
                                    _gap(o["recon"], ref_recon))
        out["attr_decoded_gap"] = max(out["attr_decoded_gap"],
                                      _gap(o["decoded"], ref_dec))
    return out
