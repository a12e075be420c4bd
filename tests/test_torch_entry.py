"""The port's single-card entry point (mpeg_pcc_tmc13_tpu_torch.entry)
held to ``__graft_entry__.entry()`` (JAX on the CPU) element for
element, and to the SHA-256 pin ``chip_smoke.py`` holds the card's run
to.
"""

import hashlib

import numpy as np
import torch

import __graft_entry__ as graft
import chip_smoke
from mpeg_pcc_tmc13_tpu_torch import entry as tentry
from mpeg_pcc_tmc13_tpu_torch.parallel import dryrun

torch.set_num_threads(2)


def test_entry_matches_jax():
    fn, (codes,) = tentry.entry(device="cpu")
    jfn, (jcodes,) = graft.entry()
    assert codes.device.type == "cpu"
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    compact, counts = fn(codes)
    jcompact, jcounts = (np.asarray(a) for a in jfn(jcodes))
    assert counts.dtype == compact.dtype == torch.int32
    assert np.array_equal(counts.numpy(), jcounts)
    total = int(jcounts.sum())
    assert 4096 <= total < jcompact.size
    # the reference's buffer holds the valid entries, then zeros
    padded = np.zeros_like(jcompact)
    padded[:compact.shape[0]] = compact.numpy()
    assert compact.shape == (total,)
    assert np.array_equal(padded, jcompact)


def test_entry_pin_is_the_jax_entrys():
    """``chip_smoke.ENTRY_SHA256`` is the hash of the JAX entry's valid
    outputs, and the port's ``entry_sha256`` gives it on the CPU."""
    jfn, jargs = graft.entry()
    jcompact, jcounts = (np.asarray(a) for a in jfn(*jargs))
    total = int(jcounts.sum())
    digest = hashlib.sha256(jcompact[:total].astype(np.int32).tobytes()
                            + jcounts.astype(np.int32).tobytes())
    assert digest.hexdigest() == chip_smoke.ENTRY_SHA256
    fn, args = tentry.entry(device="cpu")
    assert chip_smoke.entry_sha256(*fn(*args)) == chip_smoke.ENTRY_SHA256


def test_dryrun_is_re_exported():
    assert tentry.dryrun_multichip is dryrun.dryrun_multichip
