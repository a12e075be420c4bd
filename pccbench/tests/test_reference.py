"""The frozen copies under pccbench/ against the port's originals on tiny
frames: the generators, the Morton interleave, and the plain fixed-point
RAHT reference against the port's numpy spec and its DeviceFpRaht (on
the CPU, the plain versions of the card's loop); and the benchmark's own
body generator."""

import numpy as np
import pytest

from pccbench.checks import raht_fp as check
from pccbench.frames import make_frames, step_q16
from pccbench.gen import clouds
from pccbench.reference import raht_fp as ref

from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp as port_fp
from mpeg_pcc_tmc13_tpu_torch.ops.raht_fp_device import DeviceFpRaht
from mpeg_pcc_tmc13_tpu_torch.scripts import gen_clouds
from mpeg_pcc_tmc13_tpu_torch.utils import morton


def test_body_is_a_surface_like_a_capture():
    """Sorted unique codes, the same for the same seed, and a surface
    covered as a capture covers it: a node above the leaves holds about
    four of them (a random scatter over a larger surface holds two)."""
    a = clouds.make_body(8, seed=2**40 + 3)
    b = clouds.make_body(8, seed=2**40 + 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    codes, rgb = a
    assert np.all(codes[1:] > codes[:-1])
    assert rgb.shape == (codes.size, 3) and rgb.min() >= 0 \
        and rgb.max() <= 255
    parents = np.unique(codes >> 3).size
    assert 3.3 < codes.size / parents < 4.2


def test_body_seeds_give_the_same_work():
    """The seed moves jitter, thinning and colour noise, not the size."""
    n = [clouds.make_body(8, seed=s)[0].size for s in (1, 2**33 + 5, 77)]
    assert max(n) - min(n) < 0.01 * min(n)


@pytest.mark.parametrize("frame", [0, 3])
def test_lidar_generator_is_the_ports(frame):
    a = clouds.make_lidar_frame(frame, 8, 64, seed=5, ego_speed=1.0)
    b = gen_clouds.make_lidar_frame(frame, 8, 64, seed=5, ego_speed=1.0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_morton_is_the_ports():
    pos = np.random.default_rng(0).integers(0, 1 << 18, (5000, 3))
    np.testing.assert_array_equal(clouds.morton_encode(pos),
                                  morton.encode(pos))


def _tiny(bits=7, seed=11, channels=3):
    cfg = {"generator": "body_thinned", "bits": bits, "radius_scale": 0.926,
           "print_vox": 6.0, "colour_noise": 3.0, "thin": 0.02, "frames": 1}
    fr = make_frames(cfg, seed, channels=3)[0]
    return fr.codes, fr.values[:, :channels], bits


@pytest.mark.parametrize("channels", [1, 3])
def test_reference_is_the_ports_spec(channels):
    codes, vals, depth = _tiny(channels=channels)
    step = step_q16(34)
    q_ref, recon, dec = check.reference_attributes(codes, vals, depth, step)
    q_port = []
    port_fp.forward_predicted_fp(codes, vals, depth, lambda c, t: step,
                                 emit=lambda q, t: q_port.append(q))
    np.testing.assert_array_equal(q_ref, np.concatenate(q_port))
    it = iter(q_port)
    dec_port = port_fp.inverse_predicted_fp(
        codes, depth, lambda m, t: next(it), lambda c, t: step, channels)
    np.testing.assert_array_equal(dec, dec_port)
    np.testing.assert_array_equal((recon + ref.HALF) >> ref.F, dec)


def test_reference_is_the_device_loop_on_cpu():
    codes, vals, depth = _tiny(seed=12)
    step = step_q16(34)
    q_ref, recon_ref, dec_ref = check.reference_attributes(codes, vals,
                                                           depth, step)
    q_dev = []
    coder = DeviceFpRaht(codes, depth, [step] * 3, device="cpu")
    recon = coder.encode(vals, q_dev.append).numpy()
    np.testing.assert_array_equal(q_ref, np.concatenate(q_dev))
    np.testing.assert_array_equal(recon, recon_ref)


def test_float32_division_control_departs():
    """The control's quotient really is coarser than the exact one."""
    from pccbench.checks.raht_fp import float32_floordiv
    a = np.array([(1 << 40) + 12345], np.int64)
    b = np.array([3], np.int64)
    assert ref.floordiv(a, b)[0] != float32_floordiv(a, b)[0]
