"""The cell of ``tmc3-cuda`` itself (``vox10_body_cli.intra_raht``) on the
CPU at a small size: a whole run is correct and reads the CLI path's
per-layer metrics, the check's controls break its limits, and the check
reads the signalled LCP coefficients from a brick header written here
bit by bit.

The tiny cut of ``vox10_body_cli`` joins ``conftest.TINY`` when this
module is imported, so that ``test_run_cpu.py``'s cases of every cell
run this one small too when the folder runs as a whole.  Its body keeps
8 bits (~52,000 points): at that size the float32 control departs from
the reference on every seed tried, where at 7 bits it may not.
"""

import json

import numpy as np

import pytest

from pccbench import check, control, run, spec
from pccbench.checks import tmc3_colour
from pccbench.tests.conftest import ROOT, TINY

TINY.setdefault("vox10_body_cli", {"bits": 8, "frames": 2})

CELL = "vox10_body_cli.intra_raht"
SEED = 2**31 + 7
CLI_LAYERS = ("cli_prepare_ms.encode", "cli_geom_ms.encode",
              "cli_geom_ms.decode", "cli_attr_ms.encode",
              "cli_attr_ms.decode", "cli_attr_entropy_ms.encode",
              "cli_attr_entropy_ms.decode")


def test_the_configuration_names_the_cli_path():
    cfg = spec.load_cell(CELL, root=ROOT).config
    assert cfg["codec"] == "tmc3_cli" and cfg["check"] == "tmc3_colour"
    opts = tmc3_colour.options(cfg)
    assert opts["geomEngine"] == "device" and opts["qp"] == "34"
    # LCP, the fixed point and BT.709 stay at the CLI's defaults
    assert not {"lastComponentPredictionEnabled", "rahtFixedPoint",
                "colourMatrix"} & set(opts)


@pytest.mark.parametrize("traced", [False, True])
def test_cli_cell_runs_and_is_correct(tiny_root, traced):
    res = run.run_cell(spec.load_cell(CELL, root=tiny_root), SEED, 0.5,
                       traced, "cpu")
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["checks"]) == {"geom_codes_wrong", *tmc3_colour.LIMITS}
    metrics = res["metrics"]
    if traced:
        # the CLI path's spans and counters; no device on the CPU
        assert set(metrics) == set(CLI_LAYERS)
        assert all(metrics[m]["value"] > 0 for m in CLI_LAYERS)
        gaps = dict(res["breakdown"]["idle_gaps"])
        assert {"encode.attr.brick", "decode.attr.brick"} <= set(gaps)
    else:
        assert set(metrics) == {"encode_mpts", "decode_mpts", "bpp",
                                "setup_s"}


def test_cli_controls_break_the_limits(tiny_root):
    got = control.readings(spec.load_cell(CELL, root=tiny_root), SEED)
    assert not check.passes(got["control_geometry"], check.LIMITS)
    for name in ("control_float32", "control_lcp_off"):
        assert not check.passes(got[name], tmc3_colour.LIMITS), name
    assert got["control_lcp_off"]["attr_lcp_coeff_wrong"] > 0


def _ue(v):
    bits = bin(v + 1)[2:]
    return "0" * (len(bits) - 1) + bits


def _se(v):
    return _ue(2 * v - 1 if v > 0 else -2 * v)


@pytest.mark.parametrize("coeffs,layer_deltas", [
    ([5, 6, 0, -4, 8, -8, -8], []),
    ([], [(1, -2)]),
    ([3, -1], [(0, 2), (-3, 1)]),
])
def test_check_reads_the_signalled_coefficients(coeffs, layer_deltas):
    """Attribute brick headers written here bit by bit, in TLV units
    with a body behind each: the coefficients of every brick, in order."""
    def brick(cs):
        bits = _ue(0) + _ue(0) + _ue(4) + _se(0) + _se(-1)
        bits += _ue(len(layer_deltas))
        for luma, chroma in layer_deltas:
            bits += _se(luma) + _se(chroma)
        bits += _ue(len(cs))
        prev = 0
        for c in cs:
            bits += _se(c - prev)
            prev = c
        bits += _ue(0) + _ue(0)
        bits += "0" * (-len(bits) % 8)
        payload = int(bits, 2).to_bytes(len(bits) // 8, "big") + b"\xa5" * 9
        return bytes([7]) + len(payload).to_bytes(4, "big") + payload

    stream = brick(coeffs) + brick(coeffs[::-1])
    assert tmc3_colour.signalled_lcp(stream) == coeffs + coeffs[::-1]
    assert tmc3_colour.coeffs_wrong(coeffs, coeffs) == 0
    assert tmc3_colour.coeffs_wrong(coeffs + [1], coeffs) == 1


def test_the_cell_is_one_chip_and_reports_the_rates():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1
    c = spec.load_cell(CELL, root=ROOT)
    assert {m.name for m in c.end_to_end} == {"encode_mpts", "decode_mpts",
                                              "bpp", "setup_s"}
    assert {m.name for m in c.per_layer} == set(CLI_LAYERS) | {
        "device_idle.encode.cli", "device_idle.decode.cli"}


class _Card:
    """A stand-in for ``torch`` whose CUDA device reports ``peak``
    bytes allocated at most."""

    def __init__(self, peak):
        self.cuda = self
        self.peak = peak

    def synchronize(self, device):
        pass

    def max_memory_allocated(self, device):
        return self.peak


@pytest.mark.parametrize("peak", [0, 4096])
def test_cli_codec_refuses_a_port_that_leaves_the_card_unused(peak):
    """A CUDA cell whose first frame allocated nothing on the card ran
    the configuration's ``--geomEngine=device`` on the host alone: the
    codec raises in set-up's first encode, and only there."""
    import torch
    from pccbench.codecs import tmc3_cli
    from pccbench.frames import make_frames
    from pccbench.spans import Clock

    cell = spec.load_cell(CELL, root=ROOT)
    cfg = dict(cell.config, bits=6, frames=1)
    fr, = make_frames(cfg, SEED, channels=3)
    codec = tmc3_cli.make(cfg, cell.mix, [torch.device("cpu")],
                          Clock(False))
    codec.device, codec.card_seen = torch.device("cuda", 0), False
    codec.torch = _Card(peak)
    if peak == 0:
        with pytest.raises(tmc3_cli.DeviceUnused, match="cuda:0 unused"):
            codec.encode(fr.codes, fr.values)
        return
    e = codec.encode(fr.codes, fr.values)
    codec.torch.peak = 0   # checked once: later frames are not asked
    codec.encode(fr.codes, fr.values)
    codes, _ = codec.decode(e.geom, e.attr, fr.points)
    assert np.array_equal(codes, fr.codes)
