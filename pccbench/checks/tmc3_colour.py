"""The check of ``tmc3-cuda``'s colour: the decoded RGB and the signalled
last-component prediction (LCP) coefficients against the plain reference
(``reference/raht_lcp.py``), one slice a frame.

Over every coding in the window of one frame drawn from the seed:

- ``attr_decoded_gap``: the largest |decoded - reference| of an RGB
  value (a value larger than any 8-bit one where the shapes differ);
- ``attr_decoded_wrong``: the RGB values that differ from the
  reference's (all of them where the shapes differ);
- ``attr_lcp_coeff_wrong``: the LCP coefficients signalled in the
  stream's attribute brick headers that differ from the reference's,
  plus the difference in their number.

The reference codes the frame itself, from the configuration's CLI
options (``qp``, ``qpChromaOffset``, ``lastComponentPredictionEnabled``,
at tmc3's defaults where the options leave them).  It follows the
port's operation order in float64 and matches exactly: limit 0 each.
The controls (``python3 -m pccbench.control``) are the same reference
in float32, and with LCP off.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from pccbench.reference import raht_lcp

LIMITS = {"attr_decoded_gap": 0, "attr_decoded_wrong": 0,
          "attr_lcp_coeff_wrong": 0}
# a gap where the shapes disagree: larger than any 8-bit value
SHAPE_GAP = float(1 << 16)


class _Bits:
    """An MSB-first reader of exp-Golomb codes."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def bit(self) -> int:
        byte = self.data[self.pos >> 3] if self.pos >> 3 < len(self.data) \
            else 0
        self.pos += 1
        return (byte >> (7 - ((self.pos - 1) & 7))) & 1

    def ue(self) -> int:
        zeros = 0
        while self.bit() == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("corrupt ue(v)")
        value = 1
        for _ in range(zeros):
            value = (value << 1) | self.bit()
        return value - 1

    def se(self) -> int:
        u = self.ue()
        return (u + 1) >> 1 if u & 1 else -(u >> 1)


def signalled_lcp(attr: bytes) -> List[int]:
    """The LCP coefficients of every attribute brick in ``attr`` (TLV
    units: a type byte, a big-endian 32-bit length, the payload), from
    each brick header's aps id, attribute index, slice id, slice QP
    deltas, per-layer QP deltas and the delta-coded coefficients."""
    out: List[int] = []
    pos = 0
    while pos < len(attr):
        n = int.from_bytes(attr[pos + 1:pos + 5], "big")
        r = _Bits(attr[pos + 5:pos + 5 + n])
        pos += 5 + n
        r.ue(), r.ue(), r.ue(), r.se(), r.se()
        for _ in range(r.ue()):
            r.se(), r.se()
        k = 0
        for _ in range(r.ue()):
            k += r.se()
            out.append(k)
    return out


def outputs(e, values) -> dict:
    return {"decoded": values, "lcp": signalled_lcp(e.attr)}


def options(cfg: dict) -> Dict[str, str]:
    """The configuration's CLI options as a dict (``--name=value``)."""
    return dict(a[2:].split("=", 1) for a in cfg["cli_options"])


def _reference(frame, cfg: dict, dtype=torch.float64, lcp=None) -> dict:
    opts = options(cfg)
    if lcp is None:
        lcp = opts.get("lastComponentPredictionEnabled", "1") != "0"
    decoded, coeffs = raht_lcp.encode_decode(
        frame.codes, frame.values, qp=int(opts.get("qp", "4")),
        qp_chroma_offset=int(opts.get("qpChromaOffset", "0")), lcp=lcp,
        dtype=dtype)
    return {"decoded": decoded.numpy(), "lcp": coeffs}


def reference(frame, cfg: dict) -> dict:
    return _reference(frame, cfg)


def controls(frame, cfg: dict) -> Dict[str, dict]:
    """Each control's outputs for the frame, as ``outputs`` gives the
    program's."""
    return {"control_float32": _reference(frame, cfg, dtype=torch.float32),
            "control_lcp_off": _reference(frame, cfg, lcp=False)}


def _decoded(a: Optional[np.ndarray], ref: np.ndarray):
    """(gap, values wrong) of decoded values against the reference's."""
    if a is None or np.shape(a) != ref.shape:
        return SHAPE_GAP, int(ref.size)
    if a.size == 0:
        return 0.0, 0
    diff = np.abs(np.asarray(a, np.int64) - ref)
    return float(diff.max()), int(np.count_nonzero(diff))


def coeffs_wrong(got: List[int], ref: List[int]) -> int:
    n = min(len(got), len(ref))
    return sum(a != b for a, b in zip(got[:n], ref[:n])) \
        + abs(len(got) - len(ref))


def numbers(kept: List[dict], ref: dict) -> Dict[str, float]:
    """``kept``: per coding of the sampled frame, ``outputs``' dict."""
    out = {"attr_decoded_gap": 0.0, "attr_decoded_wrong": 0,
           "attr_lcp_coeff_wrong": 0}
    for o in kept:
        gap, wrong = _decoded(o["decoded"], ref["decoded"])
        out["attr_decoded_gap"] = max(out["attr_decoded_gap"], gap)
        out["attr_decoded_wrong"] += wrong
        out["attr_lcp_coeff_wrong"] += coeffs_wrong(o["lcp"], ref["lcp"])
    return out
