"""Coordinate conversion: cartesian <-> (radius, azimuth, z).

Counterpart of `tmc3/coordinate_conversion.{h,cpp}` (`convertXyzToRpl`,
`normalisedAxesWeights`, `offsetAndScale`): spherical-domain coding for
rotating-LiDAR content (angular tools, GPS angular_enabled hls.h:470+).

Quantisation conventions:
* radius   r_q = round(sqrt(x^2 + y^2))           (integer units)
* azimuth  phi_q = round(atan2(y, x) * 2^phi_bits / 2pi), wrapped to
           [0, 2^phi_bits)
* z passes through unchanged (the reference's laser-index form maps z
  via a calibrated laser table; virtual uniform "lasers" are the
  untabled equivalent and keep the transform self-contained).

Only the INVERSE transform is normative (the decoder runs it; the
encoder codes a cartesian residual against its own inverse), matching
the reference's secondary-residual design
(geometry_predictive_encoder.cpp residual coding :312-596).
"""

from __future__ import annotations

import numpy as np

PHI_BITS = 17  # azimuth quantisation (reference-ish precision)


def xyz_to_spherical(positions: np.ndarray, phi_bits: int = PHI_BITS):
    """(N,3) int xyz -> (N,3) int (r, phi, z)."""
    p = positions.astype(np.float64)
    r = np.round(np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2)).astype(np.int64)
    phi = np.arctan2(p[:, 1], p[:, 0])  # [-pi, pi]
    scale = (1 << phi_bits) / (2 * np.pi)
    phi_q = np.round(phi * scale).astype(np.int64) % (1 << phi_bits)
    return np.column_stack([r, phi_q, positions[:, 2].astype(np.int64)])


def spherical_to_xyz(sph: np.ndarray, phi_bits: int = PHI_BITS):
    """Inverse transform (normative: both sides compute identically)."""
    r = sph[:, 0].astype(np.float64)
    phi = sph[:, 1].astype(np.float64) * (2 * np.pi / (1 << phi_bits))
    x = np.round(r * np.cos(phi)).astype(np.int64)
    y = np.round(r * np.sin(phi)).astype(np.int64)
    return np.column_stack([x, y, sph[:, 2].astype(np.int64)])


def normalised_axes_weights(bbox_whd) -> np.ndarray:
    """Per-axis LoD bias weights (reference normalisedAxesWeights):
    normalise axis extents so distance metrics treat anisotropic
    content (e.g. LiDAR z range << xy range) fairly.  Q8 weights."""
    ext = np.maximum(np.asarray(bbox_whd, dtype=np.float64), 1.0)
    w = ext.max() / ext
    return np.round(np.minimum(w, 256.0) * 256.0).astype(np.int64)


# --------------------------------------------------------------------
# Per-laser calibrated form (reference laser tables: numLasers,
# lasersTheta/lasersZ, TMC3.cpp angular options; z is replaced by the
# laser index and a tiny residual against the calibrated elevation)
# --------------------------------------------------------------------

THETA_Q = 18   # fixed-point tan(theta) precision


def laser_z_pred(r: np.ndarray, laser: np.ndarray,
                 theta_q: np.ndarray, zoff: np.ndarray) -> np.ndarray:
    """Integer-exact z prediction: (r * tan_theta_q18) >> 18 + zoff.

    Arithmetic shift floors on both sides identically (normative)."""
    t = theta_q[laser].astype(np.int64)
    return ((r.astype(np.int64) * t) >> THETA_Q) + zoff[laser]


def assign_lasers(positions: np.ndarray, theta_q: np.ndarray,
                  zoff: np.ndarray) -> np.ndarray:
    """Encoder: nearest calibrated laser per point (by |z - pred_z|)."""
    p = positions.astype(np.float64)
    r = np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2)
    pred = (r[:, None] * theta_q[None, :].astype(np.float64)
            / (1 << THETA_Q)) + zoff[None, :]
    return np.argmin(np.abs(p[:, 2:3] - pred), axis=1).astype(np.int64)


def xyz_to_rpl(positions: np.ndarray, theta_q: np.ndarray,
               zoff: np.ndarray, npt: np.ndarray):
    """(N,3) xyz -> (N,3) (radius, azimuth step, laser index).

    Azimuth is quantised to the laser's scan grid (lasersNumPhiPerTurn
    steps per revolution): on-grid sweeps then chain with near-free
    unit deltas per laser."""
    p = positions.astype(np.float64)
    r = np.round(np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2)).astype(np.int64)
    laser = assign_lasers(positions, theta_q, zoff)
    phi = np.arctan2(p[:, 1], p[:, 0])
    steps = npt[laser].astype(np.float64)
    phi_q = np.round(phi * steps / (2 * np.pi)).astype(np.int64)
    phi_q = np.mod(phi_q, npt[laser])
    return np.column_stack([r, phi_q, laser])


def rpl_to_xyz(rpl: np.ndarray, theta_q: np.ndarray, zoff: np.ndarray,
               npt: np.ndarray):
    """Normative inverse: laser index + radius -> calibrated z; the
    azimuth step maps back through the laser's scan grid."""
    laser = np.clip(rpl[:, 2].astype(np.int64), 0, theta_q.size - 1)
    r = rpl[:, 0].astype(np.float64)
    phi = rpl[:, 1].astype(np.float64) \
        * (2 * np.pi / npt[laser].astype(np.float64))
    x = np.round(r * np.cos(phi)).astype(np.int64)
    y = np.round(r * np.sin(phi)).astype(np.int64)
    z = laser_z_pred(rpl[:, 0], laser, theta_q, zoff)
    return np.column_stack([x, y, z])
