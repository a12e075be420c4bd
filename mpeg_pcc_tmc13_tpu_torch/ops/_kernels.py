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
    lib.rans_quantize_tables_launch.argtypes = [vp, vp, i64, vp]
    lib.rans_quantize_tables_launch.restype = i32
    lib.rans_encode_emit_launch.argtypes = [vp, vp, vp, vp, vp, vp, i64,
                                            i32, vp]
    lib.rans_encode_emit_launch.restype = i32
    lib.rans_decode_tiles_launch.argtypes = [vp, vp, vp, i64, vp, vp, vp,
                                             vp, i64, i64, i32, i32, vp]
    lib.rans_decode_tiles_launch.restype = i32
    return lib
