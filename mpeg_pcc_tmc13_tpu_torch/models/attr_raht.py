"""RAHT attribute step sizes: counterpart of
``mpeg_pcc_tmc13_tpu/models/attr_raht.py:27-28``."""

from __future__ import annotations


def qp_to_step_q16(qp: int) -> int:
    """QP -> Q16 step, 6 QPs per octave (reference quantization.cpp:46-53)."""
    return max(1, int(round((2.0 ** ((qp - 4) / 6.0)) * 65536)))
