"""How ``correct`` is decided: the program's outputs against the plain
reference, each number beside its limit.

- ``geom_codes_wrong``: over every frame decoded in the window, the
  positions at which the decoded leaf codes differ from the frame's own
  sorted unique codes, plus the difference in length.  The configuration
  states lossless geometry: limit 0.
- ``attr_q_wrong``: over every coding in the window of one frame drawn
  from the seed, the q entries the encoder emitted that differ from the
  reference encoder's (all of them where the counts differ).
- ``attr_recon_gap``: the largest gap between the encoder's
  reconstruction (Q13) and the reference encoder's.
- ``attr_decoded_gap``: the largest gap between the decoded values and
  the reference decoder's.

The reference (``reference/raht_fp.py``) rebuilds its own structure from
the frame's codes and codes the frame's values itself.  The attribute
numbers compare the exact fixed-point closed loop that the
configuration states (``rahtFixedPoint=1``): limit 0 each.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .reference import raht_fp

LIMITS = {"geom_codes_wrong": 0, "attr_q_wrong": 0, "attr_recon_gap": 0,
          "attr_decoded_gap": 0}
# a gap where the shapes disagree: larger than any Q13 value of 8-bit data
SHAPE_GAP = float(1 << 40)


def geometry_wrong(decoded: np.ndarray, expected: np.ndarray) -> int:
    decoded = np.asarray(decoded).reshape(-1)
    n = min(decoded.size, expected.size)
    return int(np.count_nonzero(decoded[:n] != expected[:n])
               + abs(decoded.size - expected.size))


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


def attribute_numbers(outputs: List[dict], ref) -> Dict[str, float]:
    """``outputs``: per coding of the sampled frame, ``q`` (M, C),
    ``recon`` (N, C) and ``decoded`` (N, C) host arrays."""
    ref_q, ref_recon, ref_dec = ref
    out = {"attr_q_wrong": 0, "attr_recon_gap": 0.0, "attr_decoded_gap": 0.0}
    for o in outputs:
        out["attr_q_wrong"] += q_wrong(o["q"], ref_q)
        out["attr_recon_gap"] = max(out["attr_recon_gap"],
                                    _gap(o["recon"], ref_recon))
        out["attr_decoded_gap"] = max(out["attr_decoded_gap"],
                                      _gap(o["decoded"], ref_dec))
    return out


def passes(numbers: Dict[str, float]) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())


def sample_frame(seed: int, frames_done: int) -> int:
    """The frame whose attributes are judged, drawn from the seed among
    the frames the window coded."""
    rng = np.random.default_rng([seed % (1 << 63), 0x5A4D])
    return int(rng.integers(max(frames_done, 1)))
