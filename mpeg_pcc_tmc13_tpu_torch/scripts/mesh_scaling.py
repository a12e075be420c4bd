#!/usr/bin/env python
"""Mesh-scaling check: sharded frame encode on 1/2/4/8 devices.

Times the mesh-sharded geometry analysis + fixed-point RAHT block stage
per mesh size and reports the sharded frame encode's payload bytes,
which must equal the host engines' at every mesh size.  With
``--backend cpu`` the mesh entries are host entries that share the
process's cores, so wall times measure overhead, not speedup: the
table's point is that the program partitions and executes correctly at
every mesh size.  On CUDA it takes the mesh sizes of 1, 2, 4 and 8 that
the visible cards allow.

Usage:
  python -m mpeg_pcc_tmc13_tpu_torch.scripts.mesh_scaling [--backend cpu]

The PyTorch + CUDA port's copy of ``scripts/mesh_scaling.py``, on the
port's ``parallel/`` (``torch.cuda.synchronize`` in place of
``block_until_ready``).
"""
import argparse
import json
import time

import numpy as np
import torch

from ..parallel import frame as pframe
from ..parallel import slices as par
from ..utils import morton

MESH_SIZES = (1, 2, 4, 8)


def mesh_sizes(backend=None):
    """The mesh sizes to run: all of ``MESH_SIZES`` on the host, those
    the visible CUDA devices allow otherwise."""
    if backend == "cpu":
        return MESH_SIZES
    have = len(par.mesh_devices(None, backend))
    return tuple(n for n in MESH_SIZES if n <= have)


def _ready(mesh):
    """Wait for every CUDA device of the mesh (``block_until_ready``)."""
    for dev in sorted(set(mesh.devices), key=str):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def main(backend=None):
    depth = 9
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 1 << depth, (200_000, 3), dtype=np.int64)
    codes = np.unique(morton.encode(pos))
    rows = []
    for nd in mesh_sizes(backend):
        mesh = par.make_mesh(nd, backend=backend)
        blocks = par.partition_codes_padded(codes, nd)
        jb = torch.as_tensor(blocks, device=mesh.devices[0])
        res, hist = par.sharded_encode_analysis(jb, depth, mesh)
        _ready(mesh)                         # warm
        t0 = time.perf_counter()
        res, hist = par.sharded_encode_analysis(jb, depth, mesh)
        _ready(mesh)
        t_an = time.perf_counter() - t0

        v = rng.integers(-1 << 20, 1 << 20, (nd, 2048, 8, 3))
        w = rng.integers(0, 4, (nd, 2048, 8))
        w[:, :, 0] = np.maximum(w[:, :, 0], 1)
        v = torch.as_tensor(v, dtype=torch.int64, device=mesh.devices[0])
        w = torch.as_tensor(w, dtype=torch.int64, device=mesh.devices[0])
        dc, *_ = par.sharded_raht_fp_blocks(v, w, mesh)
        _ready(mesh)
        t0 = time.perf_counter()
        dc, *_ = par.sharded_raht_fp_blocks(v, w, mesh)
        _ready(mesh)
        t_bf = time.perf_counter() - t0

        devs = pframe.devices_for(nd, backend=backend)
        sl = [np.unique(blocks[s]) for s in range(nd)]
        geom, _ = pframe.encode_frame_sharded(sl, depth, devs,
                                              num_threads=nd)  # warm
        t0 = time.perf_counter()
        geom, _ = pframe.encode_frame_sharded(sl, depth, devs,
                                              num_threads=nd)
        t_e2e = time.perf_counter() - t0
        rows.append(dict(devices=nd,
                         points_per_device=int(blocks.shape[1]),
                         analysis_ms=round(t_an * 1e3, 1),
                         fp_butterfly_ms=round(t_bf * 1e3, 1),
                         frame_encode_s=round(t_e2e, 2),
                         geom_bytes=sum(len(b) for b in geom)))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=["cuda", "cpu"], default=None,
                    help="mesh of CUDA devices (default) or host entries")
    main(ap.parse_args().backend)
