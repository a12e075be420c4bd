"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a
plain C interface, under ``build/torch_kernels/`` beside the package,
named by a hash of the sources (an edited source builds anew), and
loaded with ``ctypes``.  ptxas's register and spill report of the build
is kept beside the library (``.log``).  Each launcher takes device
pointers, sizes and the CUDA stream as integers and returns
``cudaGetLastError()``.

Nothing here runs at import.  A missing ``nvcc`` or a failed build
raises; there is no fallback.  ``build()`` and ``load()`` hold a
module lock, so threads of one process that reach the kernels together
(the CLI's slice-parallel encode) build and load the library once.

The launchers' shared plumbing lives here too: ``LAUNCHES`` counts each
kernel's launches by name (the plain versions add nothing; safe to count
from several threads), ``launched`` checks a launcher's return code and
counts it, and ``ptr``/``ptrs``/``aligned`` pass tensors to a launcher.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIB = None
_LOCK = threading.RLock()

# launches of each kernel, by name: a wrapper's call counts the launches
# it made (``octree_occ_u8``: two grid passes; ``octree_expand``: a
# counting pass, then one a level; ``raht_fp_plan``: its count pass, then
# scatter and blocks)
LAUNCHES = {name: 0 for name in (
    "fwd_blocks", "inv_blocks", "table_pass", "encode_emit", "decode_level",
    "octree_occ_u8", "octree_expand", "fwd_blocks_int",
    "raht_fp_truth_level", "raht_fp_group", "raht_fp_plan",
    "raht_float_truth", "raht_float_predict", "raht_float_inverse",
    "octree_neigh_ctx")}
_COUNT_LOCK = threading.Lock()


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _find_nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtmc13_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple:
    """Compile the sources unless a library of the same hash exists.
    Returns (path, seconds spent compiling; 0.0 when it was built)."""
    with _LOCK:
        return _build()


def _build() -> tuple:
    so = library_path()
    if so.exists():
        return so, 0.0
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the CUDA "
                           "kernels")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # process and thread: no two builds share a temporary name
    tag = f"{so.stem}.{os.getpid()}.{threading.get_ident()}"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log = []
    failed = None
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}{err}")
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd, err)
    if failed is not None:
        rc, cmd, err = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}")
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stderr}")
    secs = time.perf_counter() - t0
    for _, obj, _ in jobs:
        obj.unlink()
    so.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp, so)   # atomic: a concurrent loader sees all or nothing
    return so, secs


def on_card(t) -> bool:
    """Where a wrapper's work runs: False for a CPU tensor (the plain
    version), True for a CUDA one (the kernel); any other device
    raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}: pass CPU "
                         "tensors for the plain version or CUDA tensors "
                         "for the kernel")
    return True


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launched(name: str, rc: int, n: int = 1) -> None:
    """After a launcher returned ``rc``: raise for a CUDA error, else add
    ``n`` launches to ``name``'s count (``n=0`` for a probe, which counts
    nothing)."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    if n:
        with _COUNT_LOCK:
            LAUNCHES[name] += n


def ptr(t):
    """A tensor's device pointer for a launcher, None (NULL) for None."""
    return None if t is None else t.data_ptr()


def ptrs(ts):
    """A C array of the tensors' pointers (``ptr`` of each)."""
    return (ctypes.c_void_p * len(ts))(*(ptr(t) for t in ts))


def aligned(t):
    """``t`` contiguous and starting on 16 bytes (the kernels' TMA bulk
    and cp.async copies): a view at an odd word offset is copied (on the
    launch's stream, so freeing it after the launch is safe)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream(t) -> int:
    """The current CUDA stream of ``t``'s device, as the launchers take
    it."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def load():
    """The loaded kernel library (built first if needed)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _open(build()[0])
    return _LIB


def _open(so: Path):
    """ctypes handle on the library with the launchers' signatures."""
    lib = ctypes.CDLL(str(so))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.raht_fwd_blocks_launch.argtypes = [vp, vp, vp, vp, vp, i64, i32,
                                           vp]
    lib.raht_fwd_blocks_launch.restype = i32
    lib.raht_inv_blocks_launch.argtypes = [vp, vp, vp, i64, i32, vp]
    lib.raht_inv_blocks_launch.restype = i32
    lib.raht_fwd_blocks_int_launch.argtypes = [vp, vp, vp, vp, vp, vp, i64,
                                               i32, vp]
    lib.raht_fwd_blocks_int_launch.restype = i32
    lib.rans_table_pass_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp]
    lib.rans_table_pass_launch.restype = i32
    lib.rans_encode_emit_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                            i64, i32, vp]
    lib.rans_encode_emit_launch.restype = i32
    lib.rans_emit_table_launch.argtypes = [vp, vp]
    lib.rans_emit_table_launch.restype = i32
    lib.rans_emit_chain_probe_launch.argtypes = [i32, i32, i64, vp, vp]
    lib.rans_emit_chain_probe_launch.restype = i32
    lib.rans_decode_level_launch.argtypes = [vp, vp, vp, vp, vp, i64, vp,
                                             vp, vp, i64, i32, vp]
    lib.rans_decode_level_launch.restype = i32
    lib.octree_occ_u8_launch.argtypes = [vp, i64, i32, i64, vp, i64, vp, vp]
    lib.octree_occ_u8_launch.restype = i32
    lib.octree_expand_count_launch.argtypes = [vp, i64, vp, i32, i64, vp,
                                               vp, vp]
    lib.octree_expand_count_launch.restype = i32
    lib.octree_expand_level_launch.argtypes = [vp, i64, vp, i32, i32, i64,
                                               vp, vp, vp, i64, vp, vp, i32,
                                               vp]
    lib.octree_expand_level_launch.restype = i32
    lib.octree_expand_chain_probe_launch.argtypes = [i64, vp]
    lib.octree_expand_chain_probe_launch.restype = i32
    lib.octree_neigh_ctx_launch.argtypes = [vp, i64, i32, i32, vp, vp, vp,
                                            vp]
    lib.octree_neigh_ctx_launch.restype = i32
    pp = ctypes.POINTER(ctypes.c_void_p)
    lib.raht_fp_truth_level_launch.argtypes = [pp, i64, i32, vp, i32, vp, vp,
                                               vp, vp, vp]
    lib.raht_fp_truth_level_launch.restype = i32
    lib.raht_fp_group_launch.argtypes = [
        pp, i64, i32, i32, vp, vp, vp, vp, pp, vp, pp, vp, vp, vp, vp,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8), vp,
        vp]
    lib.raht_fp_group_launch.restype = i32
    lib.raht_fp_group_smem_bytes.argtypes = [i32]
    lib.raht_fp_group_smem_bytes.restype = i32
    lib.raht_fp_plan_scratch_words.argtypes = [i64, i32]
    lib.raht_fp_plan_scratch_words.restype = i64
    lib.raht_fp_plan_count_launch.argtypes = [vp, i64, i32, vp, vp]
    lib.raht_fp_plan_count_launch.restype = i32
    lib.raht_fp_plan_build_launch.argtypes = [
        vp, i64, i32, i64, vp, pp, ctypes.POINTER(ctypes.c_int64), vp]
    lib.raht_fp_plan_build_launch.restype = i32
    lib.raht_float_truth_launch.argtypes = [pp, i64, i32, vp, vp, vp, vp, vp,
                                            vp, vp, vp]
    lib.raht_float_truth_launch.restype = i32
    lib.raht_float_predict_launch.argtypes = [
        pp, i64, i32, vp, vp, vp, vp, vp, i64,
        ctypes.POINTER(ctypes.c_double), pp, pp, pp,
        ctypes.POINTER(ctypes.c_uint8), vp]
    lib.raht_float_predict_launch.restype = i32
    lib.raht_float_inverse_launch.argtypes = [pp, i64, i32, vp, vp, pp, pp,
                                              vp, vp]
    lib.raht_float_inverse_launch.restype = i32
    return lib
