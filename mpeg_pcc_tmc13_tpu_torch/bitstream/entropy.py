"""Context-adaptive binary range coder — host entropy stage.

This is the framework's replacement for the reference's dirac/schroedinger
arithmetic coder (tmc3/entropydirac.h, dependencies/schroedinger/
schroarith.c).  The coder itself is a fresh LZMA-style binary range coder
(11-bit adaptive probabilities, carry-cached renormalisation, bypass by
range halving).  The API is *batch-first*: the TPU emits whole levels of
(context-id, symbol) tensors; these are serialised in one native call per
level (native/entropy.cc).  Context state lives in caller-owned numpy
uint16 arrays, which makes entropy continuation across slices/frames
(reference encoder.cpp:1401-1411) a simple array copy, and parallel slice
streams a simple array-per-slice.

Two interchangeable backends:

* native  — ctypes bindings to libtmc13_entropy.so (production path),
  which this package builds from its own ``native/`` sources on first
  import (``_build``: g++ into ``build/tmc13_native/``),
* python  — a pure-Python mirror used as the executable spec and fallback.

The two are cross-tested bit-identical (tests/test_entropy.py).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import time
from typing import Optional

import numpy as np

PROB_BITS = 11
PROB_INIT = 1 << (PROB_BITS - 1)
PROB_MOVE_BITS = 5
_TOP = 1 << 24

# zero-run residual layout: ctx[0..ZRUN_PREFIX) run prefix (EG(2)
# tail), ctx[ZRUN_PREFIX..] magnitude prefix (must match native
# kZrunPrefix/kZrunK in native/entropy.cc)
ZRUN_PREFIX = 20
_M32 = 0xFFFFFFFF

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
# beside the package, git-ignored; one library per hash of its inputs
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "tmc13_native")
# the translation units whose extern "C" entry points this package binds
# (the headers and .inc files they include are hashed with them)
_SOURCES = ("entropy.cc", "octree.cc", "lod.cc", "recolour.cc",
            "predtree.cc", "attr_raht.cc", "obuf_ls.cc", "refcodec.cc",
            "refpredgeom.cc", "refattr.cc", "refpredlift.cc",
            "trisoup_ref.cc", "trisoup_geom.cc")
# -ffp-contract=off: attr_raht.cc mirrors the numpy float64 spec
# op-for-op; fused multiply-adds would change the last ulp and break
# byte-identity between the native and Python coefficient streams.  No
# -march=native: a library built on one host may be loaded on another
# that shares the checkout.
CXX = os.environ.get("CXX", "g++")
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-ffp-contract=off")

LIB_PATH: Optional[str] = None    # the library loaded, once loaded
BUILD_SECONDS = 0.0               # compile time in this process


def _library_path() -> str:
    h = hashlib.sha256(" ".join((CXX, *CXXFLAGS)).encode())
    for name in sorted(os.listdir(_NATIVE_DIR)):
        if name.endswith((".cc", ".h", ".inc")):
            h.update(name.encode())
            with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
                h.update(f.read())
    return os.path.join(_BUILD_DIR,
                        f"libtmc13_entropy_{h.hexdigest()[:16]}.so")


def _build(so: str) -> float:
    """Compile every source in its own g++ process, all started together,
    link to a temporary name and move it into place.  Holds an exclusive
    lock on the build directory, so processes that import the package
    together build once, and none opens a half-written library.  Returns
    the seconds spent compiling (0.0 when another process built it)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return 0.0
        t0 = time.perf_counter()
        tag = f"{os.path.basename(so)[:-3]}.{os.getpid()}"
        jobs = []
        for src in _SOURCES:
            obj = os.path.join(_BUILD_DIR, f"{tag}.{src[:-3]}.o")
            jobs.append((obj, subprocess.Popen(
                [CXX, *CXXFLAGS, "-c", "-o", obj,
                 os.path.join(_NATIVE_DIR, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs = [p.communicate()[0] for _, p in jobs]
        objs = [obj for obj, _ in jobs]
        try:
            failed = [p.args for _, p in jobs if p.returncode != 0]
            if failed:
                raise RuntimeError(f"g++ failed: {failed}\n"
                                   + b"".join(logs).decode(errors="replace"))
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run([CXX, "-shared", "-o", tmp, *objs], check=True,
                           capture_output=True)
            os.replace(tmp, so)
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        return time.perf_counter() - t0


def _load_native() -> Optional[ctypes.CDLL]:
    global LIB_PATH, BUILD_SECONDS
    so = _library_path()
    if not os.path.exists(so):
        try:
            BUILD_SECONDS = _build(so)
        except (OSError, RuntimeError, subprocess.CalledProcessError):
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    LIB_PATH = so
    c = ctypes
    u8p, u16p, i32p, u32p = (
        c.POINTER(c.c_uint8), c.POINTER(c.c_uint16),
        c.POINTER(c.c_int32), c.POINTER(c.c_uint32),
    )
    lib.rce_new.restype = c.c_void_p
    lib.rce_free.argtypes = [c.c_void_p]
    lib.rce_size.argtypes = [c.c_void_p]
    lib.rce_size.restype = c.c_int64
    lib.rce_copy.argtypes = [c.c_void_p, u8p]
    lib.rcd_new.argtypes = [u8p, c.c_int64]
    lib.rcd_new.restype = c.c_void_p
    lib.rcd_free.argtypes = [c.c_void_p]
    lib.rcd_pos.argtypes = [c.c_void_p]
    lib.rcd_pos.restype = c.c_int64
    lib.ctx_init.argtypes = [u16p, c.c_int64]
    lib.rce_bits.argtypes = [c.c_void_p, u16p, i32p, u8p, c.c_int64]
    lib.rcd_bits.argtypes = [c.c_void_p, u16p, i32p, u8p, c.c_int64]
    lib.rce_bypass.argtypes = [c.c_void_p, u32p, i32p, c.c_int64]
    lib.rcd_bypass.argtypes = [c.c_void_p, u32p, i32p, c.c_int64]
    lib.rce_ueg.argtypes = [c.c_void_p, u16p, i32p, u32p, c.c_int64,
                            c.c_int32, c.c_int32]
    lib.rcd_ueg.argtypes = [c.c_void_p, u16p, i32p, u32p, c.c_int64,
                            c.c_int32, c.c_int32]
    lib.rce_occupancy.argtypes = [c.c_void_p, u16p, i32p, u8p, c.c_int64]
    lib.rcd_occupancy.argtypes = [c.c_void_p, u16p, i32p, u8p, c.c_int64]
    lib.rce_occ_sym.argtypes = [c.c_void_p, u16p, i32p, u8p, c.c_int64]
    lib.rcd_occ_sym.argtypes = [c.c_void_p, u16p, i32p, u8p, c.c_int64]
    lib.rce_occ_stream.argtypes = [c.c_void_p, u16p, u8p, c.c_int64,
                                   c.c_int32]
    lib.rce_occ_stream.restype = c.c_int64
    lib.rcd_occ_stream.argtypes = [c.c_void_p, u16p, u8p, c.c_int64,
                                   c.c_int32]
    lib.rcd_occ_stream.restype = c.c_int64
    lib.occ_huff_table.argtypes = [u8p, u16p]
    lib.occ_unpack.argtypes = [u8p, u8p, c.c_int64]
    lib.sym_contexts_init.argtypes = [u16p, c.c_int64]
    lib.rce_residuals.argtypes = [c.c_void_p, u16p, i32p, c.c_int64,
                                  c.c_int32, c.c_int32]
    lib.rcd_residuals.argtypes = [c.c_void_p, u16p, i32p, c.c_int64,
                                  c.c_int32, c.c_int32]
    lib.rce_zrun.argtypes = [c.c_void_p, u16p, i32p, c.c_int64,
                             c.c_int32, c.c_int32]
    lib.rcd_zrun.argtypes = [c.c_void_p, u16p, i32p, c.c_int64,
                             c.c_int32, c.c_int32]
    lib.rce_zrow.argtypes = [c.c_void_p, u16p, i32p, c.c_int64,
                             c.c_int32]
    lib.rcd_zrow.argtypes = [c.c_void_p, u16p, i32p, c.c_int64,
                             c.c_int32]
    lib.rcd_bits_chain.argtypes = [c.c_void_p, u16p, u8p, c.c_int64]
    lib.rcd_mode_chain.argtypes = [c.c_void_p, u16p, u8p, c.c_int64]
    lib.rce_resbl.argtypes = [c.c_void_p, u16p, i32p, c.c_int64]
    lib.rcd_resbl.argtypes = [c.c_void_p, u16p, i32p, c.c_int64]
    i64p = c.POINTER(c.c_int64)
    lib.oct_encode.argtypes = [c.c_void_p, u16p, i64p, c.c_int64,
                               c.c_int32, c.c_int32, c.c_int32]
    lib.oct_encode.restype = c.c_int64
    lib.oct_decode.argtypes = [c.c_void_p, u16p, i64p, c.c_int64,
                               c.c_int32, c.c_int32, c.c_int32]
    lib.oct_decode.restype = c.c_int64
    lib.radix_sort64.argtypes = [i64p, i64p, c.c_int64]
    lib.morton_encode64.argtypes = [i64p, c.c_int64, i64p]
    lib.morton_decode64.argtypes = [i64p, c.c_int64, i64p]
    lib.morton_sort.argtypes = [i64p, c.c_int64, i64p, i64p]
    lib.lod_assign_dist2.argtypes = [i64p, c.c_int64, c.c_int64,
                                     c.c_int32, u8p]
    lib.lod_assign_dist2.restype = c.c_int32
    lib.oct_encode_inter.argtypes = [c.c_void_p, u16p, i64p, c.c_int64,
                                     c.c_int32, i64p, c.c_int64,
                                     c.c_int32]
    lib.oct_encode_inter.restype = c.c_int64
    lib.oct_decode_inter.argtypes = [c.c_void_p, u16p, i64p, c.c_int64,
                                     c.c_int32, i64p, c.c_int64,
                                     c.c_int32]
    lib.oct_decode_inter.restype = c.c_int64
    # full predicted-RAHT attribute engine (attr_raht.cc)
    lib.raht_encode_predicted.argtypes = [
        c.c_void_p, u16p, i64p, c.c_int64, c.c_int32, i64p, c.c_int32,
        i32p, c.c_int64, c.c_int64, c.c_int32, c.c_int32, c.c_int32]
    lib.raht_encode_predicted.restype = c.c_int32
    lib.raht_decode_predicted.argtypes = [
        c.c_void_p, u16p, i64p, c.c_int64, c.c_int32, i64p, c.c_int32,
        i32p, c.c_int64, c.c_int64, c.c_int32, c.c_int32, c.c_int32]
    lib.raht_decode_predicted.restype = c.c_int32
    lib.raht_encode_fp.argtypes = [
        c.c_void_p, u16p, i64p, c.c_int64, c.c_int32, i64p, c.c_int32,
        i32p, c.c_int64, c.c_int64, c.c_int32, c.c_int32, c.c_int32]
    lib.raht_encode_fp.restype = c.c_int32
    lib.raht_decode_fp.argtypes = [
        c.c_void_p, u16p, i64p, c.c_int64, c.c_int32, i64p, c.c_int32,
        i32p, c.c_int64, c.c_int64, c.c_int32, c.c_int32, c.c_int32]
    lib.raht_decode_fp.restype = c.c_int32
    lib.rce_trisoup_verts2.argtypes = [c.c_void_p, u16p, u8p, i32p,
                                       i64p, i32p, u16p, u8p, u8p,
                                       u8p, u8p, c.c_int64, c.c_int]
    lib.rcd_trisoup_verts2.argtypes = [c.c_void_p, u16p, u8p, i32p,
                                       i64p, i32p, u16p, u8p, u8p,
                                       u8p, u8p, c.c_int64, c.c_int]
    lib.rce_trisoup_verts.argtypes = [c.c_void_p, u16p, u8p, i32p,
                                      i32p, i64p, i64p, c.c_int64,
                                      c.c_int32]
    lib.rcd_trisoup_verts.argtypes = [c.c_void_p, u16p, u8p, i32p,
                                      i32p, i64p, i64p, c.c_int64,
                                      c.c_int32]
    return lib


_LIB = _load_native()


def native_available() -> bool:
    return _LIB is not None


def new_contexts(n: int) -> np.ndarray:
    """Allocate n adaptive contexts initialised to p=0.5."""
    return np.full(n, PROB_INIT, dtype=np.uint16)


# ---- bytewise occupancy model (Fenwick 256-symbol trees) -------------
SYM_N = 256
_SYM_INC = 24
_SYM_LIMIT = 1 << 13


def new_sym_contexts(num_bases: int) -> np.ndarray:
    """Per base: adaptive 256-symbol frequency table as a Fenwick tree
    (uint16[256]; all frequencies start at 1, total in slot 255)."""
    t = np.array([i & -i for i in range(1, SYM_N + 1)], dtype=np.uint16)
    return np.tile(t, num_bases)


def _fen_prefix(t, base, i):
    s = 0
    while i > 0:
        s += int(t[base + i - 1])
        i -= i & -i
    return s


def _fen_add(t, base, sym, d):
    j = sym + 1
    while j <= SYM_N:
        t[base + j - 1] = np.uint16((int(t[base + j - 1]) + d) & 0xFFFF)
        j += j & -j


def _fen_find(t, base, dv):
    pos, cum, b = 0, 0, SYM_N >> 1
    while b:
        nxt = pos + b
        if nxt <= SYM_N and cum + int(t[base + nxt - 1]) <= dv:
            pos, cum = nxt, cum + int(t[base + nxt - 1])
        b >>= 1
    if pos >= SYM_N:
        pos = SYM_N - 1
    return pos, cum


def _sym_rescale(t, base):
    prev = 0
    f = np.zeros(SYM_N, dtype=np.uint16)
    for i in range(SYM_N):
        cur = _fen_prefix(t, base, i + 1)
        f[i] = ((cur - prev) + 1) >> 1
        prev = cur
    t[base:base + SYM_N] = f
    for i in range(1, SYM_N + 1):
        j = i + (i & -i)
        if j <= SYM_N:
            t[base + j - 1] = np.uint16(int(t[base + j - 1])
                                        + int(t[base + i - 1]))


def _sym_adapt(t, base, sym, total):
    _fen_add(t, base, sym, _SYM_INC)
    if total + _SYM_INC >= _SYM_LIMIT:
        _sym_rescale(t, base)


def _as(arr, dtype):
    a = np.ascontiguousarray(arr, dtype=dtype)
    return a


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


# =====================================================================
# Pure-Python backend (executable spec)
# =====================================================================


class _PyEncoder:
    def __init__(self):
        self.out = bytearray()
        self.low = 0
        self.range = _M32
        self.cache = 0
        self.cache_size = 1
        self.flushed = False

    def _shift_low(self):
        if (self.low & _M32) < 0xFF000000 or (self.low >> 32) != 0:
            carry = self.low >> 32
            temp = self.cache
            while True:
                self.out.append((temp + carry) & 0xFF)
                temp = 0xFF
                self.cache_size -= 1
                if self.cache_size == 0:
                    break
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low << 8) & _M32

    def encode_bit(self, ctx, idx, bit):
        p = int(ctx[idx])
        bound = (self.range >> PROB_BITS) * p
        if not bit:
            self.range = bound
            ctx[idx] = p + (((1 << PROB_BITS) - p) >> PROB_MOVE_BITS)
        else:
            self.low += bound
            self.range -= bound
            ctx[idx] = p - (p >> PROB_MOVE_BITS)
        while self.range < _TOP:
            self._shift_low()
            self.range = (self.range << 8) & _M32

    def encode_bypass(self, bit):
        self.range >>= 1
        if bit:
            self.low += self.range
        while self.range < _TOP:
            self._shift_low()
            self.range = (self.range << 8) & _M32

    def encode_bypass_bits(self, v, nbits):
        for i in range(nbits - 1, -1, -1):
            self.encode_bypass((v >> i) & 1)

    def _enc_ueg(self, ctx, base, v, prefix_max, k):
        v = int(v)
        for i in range(prefix_max):
            more = v > i
            self.encode_bit(ctx, base + i, more)
            if not more:
                return
        r = v - prefix_max
        m = (r >> k) + 1
        nb = m.bit_length() - 1
        for _ in range(nb):
            self.encode_bypass(1)
        self.encode_bypass(0)
        for j in range(nb - 1, -1, -1):
            self.encode_bypass((m >> j) & 1)
        self.encode_bypass_bits(r & ((1 << k) - 1), k)

    def flush(self):
        if not self.flushed:
            for _ in range(5):
                self._shift_low()
            self.flushed = True

    # batch ops ----------------------------------------------------
    def bits(self, ctx, ctx_ids, bits):
        for i, b in zip(ctx_ids, bits):
            self.encode_bit(ctx, int(i), int(b))

    def bypass(self, vals, nbits):
        for v, n in zip(vals, nbits):
            self.encode_bypass_bits(int(v), int(n))

    def ueg(self, ctx, bases, vals, prefix_max, k):
        for b, v in zip(bases, vals):
            self._enc_ueg(ctx, int(b), int(v), prefix_max, k)

    def occupancy(self, ctx, base_ctx, occ):
        for bc, byte in zip(base_ctx, occ):
            base = int(bc) * 255
            t = 1
            byte = int(byte)
            for j in range(7, -1, -1):
                bit = (byte >> j) & 1
                if j == 0 and t == 128:
                    break
                self.encode_bit(ctx, base + t - 1, bit)
                t = (t << 1) | bit

    def occupancy_sym(self, ctx, base_ctx, occ):
        for bc, sym in zip(base_ctx, occ):
            base = int(bc) * SYM_N
            sym = int(sym)
            total = int(ctx[base + SYM_N - 1])
            cum = _fen_prefix(ctx, base, sym)
            f = _fen_prefix(ctx, base, sym + 1) - cum
            r = self.range // total
            self.low += r * cum
            self.range = r * f
            while self.range < _TOP:
                self._shift_low()
                self.range = (self.range << 8) & _M32
            _sym_adapt(ctx, base, sym, total)

    def residuals(self, ctx, vals, prefix_max, k):
        prev_nz = 0
        for v in vals:
            v = int(v)
            nz = 1 if v != 0 else 0
            self.encode_bit(ctx, prev_nz, 0 if nz else 1)
            if nz:
                self.encode_bypass(1 if v < 0 else 0)
                self._enc_ueg(ctx, 2, abs(v) - 1, prefix_max, k)
            prev_nz = nz

    def zrun_residuals(self, ctx, vals, prefix_max, k):
        """Sparse variant: zero-RUN length before each nonzero
        (ctx[0..19] prefix + EG(2)), then sign + magnitude
        (ctx[20..]).  Mirror of native rce_zrun."""
        n = len(vals)
        i = 0
        while i < n:
            j = i
            while j < n and int(vals[j]) == 0:
                j += 1
            self._enc_ueg(ctx, 0, j - i, ZRUN_PREFIX, 2)
            if j >= n:
                return
            v = int(vals[j])
            self.encode_bypass(1 if v < 0 else 0)
            self._enc_ueg(ctx, ZRUN_PREFIX, abs(v) - 1, prefix_max, k)
            i = j + 1

    # joint row residual coder (mirror of native rce_zrow; layout in
    # native/entropy.cc kZrowCtx comment)
    def _enc_egk_ctx(self, ctx, base, v, k):
        while v >= (1 << k):
            self.encode_bit(ctx, base, 1)
            v -= 1 << k
            k += 1
        self.encode_bit(ctx, base, 0)
        for j in range(k - 1, -1, -1):
            self.encode_bypass((v >> j) & 1)

    def _enc_zrow_run(self, ctx, run):
        for i in range(min(run, 3)):
            self.encode_bit(ctx, i, 1)
        if run < 3:
            self.encode_bit(ctx, run, 0)
            return
        run -= 3
        for i in range(min(run >> 1, 4)):
            self.encode_bit(ctx, 3, 1)
        if run < 8:
            self.encode_bit(ctx, 3, 0)
            self.encode_bypass(run & 1)
            return
        self._enc_egk_ctx(ctx, 4, run - 8, 2)

    def _enc_egk_rem(self, ctx, pbase, sbase, v, k):
        # positional prefix + adaptive suffix contexts (native
        # enc_egk_rem; reference entropyutils.h:210-239)
        k0 = k
        while v >= (1 << k):
            self.encode_bit(ctx, pbase + min(k - k0, 2), 1)
            v -= 1 << k
            k += 1
        self.encode_bit(ctx, pbase + min(k - k0, 2), 0)
        for j in range(k - 1, -1, -1):
            self.encode_bit(ctx, sbase + min(j, 2), (v >> j) & 1)

    def _enc_zrow_sym(self, ctx, v, k1, k2, k3):
        self.encode_bit(ctx, 5 + k1, 1 if v > 0 else 0)
        if not v:
            return
        v -= 1
        self.encode_bit(ctx, 12 + k2, 1 if v > 0 else 0)
        if not v:
            return
        self._enc_egk_rem(ctx, 19 + 3 * k3, 25 + 3 * k3, v - 1, 1)

    def zrow_residuals(self, ctx, rows):
        rows = np.asarray(rows)
        n, ncomp = rows.shape
        i = 0
        nz = np.flatnonzero((rows != 0).any(axis=1))
        for j in nz:
            self._enc_zrow_run(ctx, int(j - i))
            row = [int(v) for v in rows[j]]
            if ncomp == 1:
                self._enc_zrow_sym(ctx, abs(row[0]) - 1, 0, 0, 0)
                self.encode_bypass(1 if row[0] < 0 else 0)
            else:
                m0, m1 = abs(row[0]), abs(row[1])
                m2 = abs(row[2]) if ncomp > 2 else 0
                b0, b1 = int(m1 == 0), int(m1 <= 1)
                b2, b3 = int(m2 == 0), int(m2 <= 1)
                self._enc_zrow_sym(ctx, m1, 0, 0, 1)
                self._enc_zrow_sym(ctx, m2, 1 + b0, 1 + b1, 1)
                m0x = m0 - 1 if (b0 and b2) else m0
                self._enc_zrow_sym(ctx, m0x, 3 + (b0 << 1) + b2,
                                   3 + (b1 << 1) + b3, 0)
                for m, v in ((m0, row[0]), (m1, row[1]), (m2, row[2])) \
                        if ncomp > 2 else ((m0, row[0]), (m1, row[1])):
                    if m:
                        self.encode_bypass(1 if v < 0 else 0)
            i = int(j) + 1
        if i < n:
            self._enc_zrow_run(ctx, n - i)

    def trisoup_verts(self, ctx, pres, vpos, nadj, prev1, prev2,
                      nbits):
        """Trisoup edge-vertex coder spec (mirror of native
        rce_trisoup_verts; layout documented there)."""
        prev = 0
        for i in range(len(pres)):
            s1 = 0 if prev1[i] < 0 else (2 if pres[prev1[i]] else 1)
            s2 = 0 if prev2[i] < 0 else (2 if pres[prev2[i]] else 1)
            na = min(max(int(nadj[i]), 1), 4)
            cid = ((na - 1) * 2 + prev) * 9 + s1 * 3 + s2
            self.encode_bit(ctx, cid, int(pres[i]))
            prev = 1 if pres[i] else 0
            if not pres[i]:
                continue
            cnt, sm = 0, 0
            if prev1[i] >= 0 and pres[prev1[i]]:
                sm += int(vpos[prev1[i]]); cnt += 1
            if prev2[i] >= 0 and pres[prev2[i]]:
                sm += int(vpos[prev2[i]]); cnt += 1
            pv = (sm + (cnt >> 1)) // cnt if cnt else -1
            v = int(vpos[i])
            for b in range(nbits - 1, -1, -1):
                bi = nbits - 1 - b
                bucket = 2 if pv < 0 else ((pv >> b) & 1)
                self.encode_bit(ctx, 72 + bi * 3 + bucket,
                                (v >> b) & 1)


    def _tri2_gather(self, pres, vpos, nbr9, orient, nbits):
        npres = nclose = nclosest = closest_start = missed = 0
        for j in range(9):
            idx = int(nbr9[j])
            if idx < 0:
                continue
            if not pres[idx]:
                if j <= 4:
                    missed += 1
                continue
            npres += 1
            v2b = (int(vpos[idx]) >> (nbits - 2)) if nbits >= 2 \
                else int(vpos[idx])
            v2b = min(v2b, 3)
            if (orient >> j) & 1:
                v2b = 3 - v2b
            if v2b >= 2:
                nclose += 1
            if v2b == 3:
                nclosest += 1
                if j <= 4:
                    closest_start = 1
        return npres, nclose, nclosest, closest_start, missed

    @staticmethod
    def _tri2_pres_ctx(nclosest, cmult, nafter, npres, dirn):
        cA = min(nclosest, 2)
        cB = min(max(cmult - 1, 0), 3)
        cC = min(nafter, 2)
        cD = min(npres, 2)
        return (((cA * 4 + cB) * 3 + cC) * 3 + cD) * 3 + dirn

    def trisoup_verts2(self, ctx, pres, vpos, order, nbr, orient,
                       cmult, nbefore, nafter, dirn, nbits):
        """v2 trisoup vertex coder spec (native rce_trisoup_verts2):
        9-neighbour-edge conditioning, position-major order."""
        for k in range(len(order)):
            i = int(order[k])
            npres, nclose, nclosest, cstart, missed = \
                self._tri2_gather(pres, vpos, nbr[i], int(orient[i]),
                                  nbits)
            cid = self._tri2_pres_ctx(nclosest, int(cmult[i]),
                                      int(nafter[i]), npres,
                                      int(dirn[i]))
            self.encode_bit(ctx, cid, int(pres[i]))
            if not pres[i]:
                continue
            q0 = min(int(nbefore[i]), 2)
            q1 = min(int(nafter[i]), 2)
            full = 1 if int(cmult[i]) >= 4 else 0
            v = int(vpos[i])
            coded = 0
            for b in range(nbits - 1, -1, -1):
                bi = nbits - 1 - b
                bit = (v >> b) & 1
                if bi == 0:
                    f = (q0 * 3 + q1) * 2 + full
                    self.encode_bit(
                        ctx,
                        324 + (f * 2 + (1 if nclosest else 0)) * 2
                        + cstart, bit)
                elif bi == 1:
                    f = (q0 * 3 + q1) * 2 + full
                    self.encode_bit(
                        ctx,
                        396 + (f * 2 + (1 if nclosest else 0)) * 2
                        + cstart + 72 * coded, bit)
                elif bi == 2:
                    m = min(missed, 4)
                    f2 = (m * 3 + q0) * 2 + full
                    self.encode_bit(ctx, 540 + f2 * 4 + (coded & 3),
                                    bit)
                else:
                    self.encode_bit(ctx, 660 + bi * 2 + (coded & 1),
                                    bit)
                coded = (coded << 1) | bit

    def resbl(self, ctx, vals):
        prev_nz = 0
        for v in vals:
            v = int(v)
            nz = 1 if v != 0 else 0
            self.encode_bit(ctx, prev_nz, 0 if nz else 1)
            if nz:
                self.encode_bypass(1 if v < 0 else 0)
                mag = abs(v)
                nb = mag.bit_length() - 1
                for j in range(nb):
                    self.encode_bit(ctx, 2 + j, 1)
                if nb < 23:
                    self.encode_bit(ctx, 2 + nb, 0)
                if nb > 0:
                    self.encode_bypass_bits(mag & ((1 << nb) - 1), nb)
            prev_nz = nz

    def get_bytes(self):
        self.flush()
        return bytes(self.out)


class _PyDecoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.range = _M32
        self.code = 0
        self._next()  # initial cache byte
        for _ in range(4):
            self.code = ((self.code << 8) | self._next()) & _M32

    def _next(self):
        if self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            return b
        return 0

    def decode_bit(self, ctx, idx):
        p = int(ctx[idx])
        bound = (self.range >> PROB_BITS) * p
        if self.code < bound:
            self.range = bound
            ctx[idx] = p + (((1 << PROB_BITS) - p) >> PROB_MOVE_BITS)
            bit = 0
        else:
            self.code -= bound
            self.range -= bound
            ctx[idx] = p - (p >> PROB_MOVE_BITS)
            bit = 1
        while self.range < _TOP:
            self.range = (self.range << 8) & _M32
            self.code = ((self.code << 8) | self._next()) & _M32
        return bit

    def decode_bypass(self):
        self.range >>= 1
        bit = 0
        if self.code >= self.range:
            self.code -= self.range
            bit = 1
        while self.range < _TOP:
            self.range = (self.range << 8) & _M32
            self.code = ((self.code << 8) | self._next()) & _M32
        return bit

    def decode_bypass_bits(self, nbits):
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.decode_bypass()
        return v

    def _dec_ueg(self, ctx, base, prefix_max, k):
        for i in range(prefix_max):
            if not self.decode_bit(ctx, base + i):
                return i
        nb = 0
        while self.decode_bypass():
            nb += 1
        m = 1
        for _ in range(nb):
            m = (m << 1) | self.decode_bypass()
        r = ((m - 1) << k) | self.decode_bypass_bits(k)
        return prefix_max + r

    # batch ops ----------------------------------------------------
    def bits(self, ctx, ctx_ids):
        return np.array(
            [self.decode_bit(ctx, int(i)) for i in ctx_ids], dtype=np.uint8)

    def bits_chain(self, ctx, n):
        out = np.zeros(n, dtype=np.uint8)
        prev = 0
        for i in range(n):
            prev = self.decode_bit(ctx, prev)
            out[i] = prev
        return out

    def mode_chain(self, ctx, n):
        out = np.zeros(n, dtype=np.uint8)
        prev = 0
        for i in range(n):
            hi = self.decode_bit(ctx, prev * 2)
            lo = self.decode_bit(ctx, prev * 2 + 1)
            prev = (hi << 1) | lo
            out[i] = prev
        return out

    def bypass(self, nbits):
        return np.array(
            [self.decode_bypass_bits(int(n)) for n in nbits], dtype=np.uint32)

    def ueg(self, ctx, bases, prefix_max, k):
        return np.array(
            [self._dec_ueg(ctx, int(b), prefix_max, k) for b in bases],
            dtype=np.uint32)

    def occupancy(self, ctx, base_ctx):
        out = np.zeros(len(base_ctx), dtype=np.uint8)
        for n, bc in enumerate(base_ctx):
            base = int(bc) * 255
            t = 1
            for j in range(7, -1, -1):
                if j == 0 and t == 128:
                    bit = 1
                else:
                    bit = self.decode_bit(ctx, base + t - 1)
                t = (t << 1) | bit
            out[n] = t & 0xFF
        return out

    def occupancy_sym(self, ctx, base_ctx):
        out = np.zeros(len(base_ctx), dtype=np.uint8)
        for n, bc in enumerate(base_ctx):
            base = int(bc) * SYM_N
            total = int(ctx[base + SYM_N - 1])
            r = self.range // total
            dv = self.code // r
            if dv >= total:
                dv = total - 1
            sym, cum = _fen_find(ctx, base, dv)
            f = _fen_prefix(ctx, base, sym + 1) - cum
            self.code -= r * cum
            self.range = r * f
            while self.range < _TOP:
                self.range = (self.range << 8) & _M32
                self.code = ((self.code << 8) | self._next()) & _M32
            out[n] = sym
            _sym_adapt(ctx, base, sym, total)
        return out

    def residuals(self, ctx, n, prefix_max, k):
        out = np.zeros(n, dtype=np.int32)
        prev_nz = 0
        for i in range(n):
            zero = self.decode_bit(ctx, prev_nz)
            if zero:
                prev_nz = 0
            else:
                neg = self.decode_bypass()
                mag = self._dec_ueg(ctx, 2, prefix_max, k) + 1
                out[i] = -mag if neg else mag
                prev_nz = 1
        return out

    def zrun_residuals(self, ctx, n, prefix_max, k):
        out = np.zeros(n, dtype=np.int32)
        i = 0
        while i < n:
            run = self._dec_ueg(ctx, 0, ZRUN_PREFIX, 2)
            i += run
            if i >= n:
                return out
            neg = self.decode_bypass()
            mag = self._dec_ueg(ctx, ZRUN_PREFIX, prefix_max, k) + 1
            out[i] = -mag if neg else mag
            i += 1
        return out

    def _dec_egk_ctx(self, ctx, base, k):
        v = 0
        while self.decode_bit(ctx, base):
            v += 1 << k
            k += 1
        r = 0
        for _ in range(k):
            r = (r << 1) | self.decode_bypass()
        return v + r

    def _dec_zrow_run(self, ctx):
        u = 0
        while u < 3 and self.decode_bit(ctx, u):
            u += 1
        if u < 3:
            return u
        prefix = 0
        while prefix < 4 and self.decode_bit(ctx, 3):
            prefix += 1
        if prefix < 4:
            return 3 + 2 * prefix + self.decode_bypass()
        return 11 + self._dec_egk_ctx(ctx, 4, 2)

    def _dec_egk_rem(self, ctx, pbase, sbase, k):
        k0 = k
        base = 0
        while self.decode_bit(ctx, pbase + min(k - k0, 2)):
            base += 1 << k
            k += 1
        v = 0
        for j in range(k - 1, -1, -1):
            v |= self.decode_bit(ctx, sbase + min(j, 2)) << j
        return base + v

    def _dec_zrow_sym(self, ctx, k1, k2, k3):
        if not self.decode_bit(ctx, 5 + k1):
            return 0
        if not self.decode_bit(ctx, 12 + k2):
            return 1
        return 2 + self._dec_egk_rem(ctx, 19 + 3 * k3, 25 + 3 * k3, 1)

    def zrow_residuals(self, ctx, n, ncomp):
        out = np.zeros((n, ncomp), dtype=np.int32)
        i = 0
        while i < n:
            i += self._dec_zrow_run(ctx)
            if i >= n:
                return out
            if ncomp == 1:
                mag = self._dec_zrow_sym(ctx, 0, 0, 0) + 1
                out[i, 0] = -mag if self.decode_bypass() else mag
            else:
                m1 = self._dec_zrow_sym(ctx, 0, 0, 1)
                b0, b1 = int(m1 == 0), int(m1 <= 1)
                m2 = self._dec_zrow_sym(ctx, 1 + b0, 1 + b1, 1)
                b2, b3 = int(m2 == 0), int(m2 <= 1)
                m0 = self._dec_zrow_sym(ctx, 3 + (b0 << 1) + b2,
                                        3 + (b1 << 1) + b3, 0)
                if b0 and b2:
                    m0 += 1
                if m0:
                    out[i, 0] = -m0 if self.decode_bypass() else m0
                if m1:
                    out[i, 1] = -m1 if self.decode_bypass() else m1
                if ncomp > 2 and m2:
                    out[i, 2] = -m2 if self.decode_bypass() else m2
            i += 1
        return out

    def resbl(self, ctx, n):
        out = np.zeros(n, dtype=np.int32)
        prev_nz = 0
        for i in range(n):
            zero = self.decode_bit(ctx, prev_nz)
            if zero:
                prev_nz = 0
            else:
                neg = self.decode_bypass()
                nb = 0
                while nb < 23 and self.decode_bit(ctx, 2 + nb):
                    nb += 1
                mag = 1
                if nb > 0:
                    mag = (1 << nb) | self.decode_bypass_bits(nb)
                out[i] = -mag if neg else mag
                prev_nz = 1
        return out

    def trisoup_verts(self, ctx, nadj, prev1, prev2, ne, nbits):
        """Decoder mirror of trisoup_verts; returns (pres, vpos)."""
        pres = np.zeros(ne, dtype=np.uint8)
        vpos = np.zeros(ne, dtype=np.int32)
        prev = 0
        for i in range(ne):
            s1 = 0 if prev1[i] < 0 else (2 if pres[prev1[i]] else 1)
            s2 = 0 if prev2[i] < 0 else (2 if pres[prev2[i]] else 1)
            na = min(max(int(nadj[i]), 1), 4)
            cid = ((na - 1) * 2 + prev) * 9 + s1 * 3 + s2
            p = self.decode_bit(ctx, cid)
            pres[i] = p
            prev = p
            if not p:
                continue
            cnt, sm = 0, 0
            if prev1[i] >= 0 and pres[prev1[i]]:
                sm += int(vpos[prev1[i]]); cnt += 1
            if prev2[i] >= 0 and pres[prev2[i]]:
                sm += int(vpos[prev2[i]]); cnt += 1
            pv = (sm + (cnt >> 1)) // cnt if cnt else -1
            v = 0
            for b in range(nbits - 1, -1, -1):
                bi = nbits - 1 - b
                bucket = 2 if pv < 0 else ((pv >> b) & 1)
                v |= self.decode_bit(ctx, 72 + bi * 3 + bucket) << b
            vpos[i] = v
        return pres, vpos

    def trisoup_verts2(self, ctx, order, nbr, orient, cmult, nbefore,
                       nafter, dirn, ne, nbits):
        """Decoder mirror of trisoup_verts2; returns (pres, vpos)."""
        pres = np.zeros(ne, dtype=np.uint8)
        vpos = np.zeros(ne, dtype=np.int32)
        enc = RangeEncoder  # reuse the static helpers
        for k in range(len(order)):
            i = int(order[k])
            npres, nclose, nclosest, cstart, missed = \
                RangeEncoder._tri2_gather(
                    None, pres, vpos, nbr[i], int(orient[i]), nbits)
            cid = enc._tri2_pres_ctx(nclosest, int(cmult[i]),
                                     int(nafter[i]), npres,
                                     int(dirn[i]))
            p = self.decode_bit(ctx, cid)
            pres[i] = p
            if not p:
                continue
            q0 = min(int(nbefore[i]), 2)
            q1 = min(int(nafter[i]), 2)
            full = 1 if int(cmult[i]) >= 4 else 0
            v = 0
            coded = 0
            for b in range(nbits - 1, -1, -1):
                bi = nbits - 1 - b
                if bi == 0:
                    f = (q0 * 3 + q1) * 2 + full
                    bit = self.decode_bit(
                        ctx, 324 + (f * 2 + (1 if nclosest else 0)) * 2
                        + cstart)
                elif bi == 1:
                    f = (q0 * 3 + q1) * 2 + full
                    bit = self.decode_bit(
                        ctx, 396 + (f * 2 + (1 if nclosest else 0)) * 2
                        + cstart + 72 * coded)
                elif bi == 2:
                    m = min(missed, 4)
                    f2 = (m * 3 + q0) * 2 + full
                    bit = self.decode_bit(ctx,
                                          540 + f2 * 4 + (coded & 3))
                else:
                    bit = self.decode_bit(ctx,
                                          660 + bi * 2 + (coded & 1))
                v = (v << 1) | bit
                coded = (coded << 1) | bit
            vpos[i] = v
        return pres, vpos



# =====================================================================
# Native backend
# =====================================================================


class _NativeEncoder:
    def __init__(self):
        self._lib = _LIB  # keep a ref: module globals may be torn down first
        self._h = _LIB.rce_new()

    def __del__(self):
        if getattr(self, "_h", None) and getattr(self, "_lib", None):
            self._lib.rce_free(self._h)
            self._h = None

    def bits(self, ctx, ctx_ids, bits):
        ids = _as(ctx_ids, np.int32)
        bs = _as(bits, np.uint8)
        _LIB.rce_bits(self._h, _ptr(ctx, ctypes.c_uint16),
                      _ptr(ids, ctypes.c_int32), _ptr(bs, ctypes.c_uint8),
                      len(ids))

    def bypass(self, vals, nbits):
        v = _as(vals, np.uint32)
        n = _as(nbits, np.int32)
        _LIB.rce_bypass(self._h, _ptr(v, ctypes.c_uint32),
                        _ptr(n, ctypes.c_int32), len(v))

    def ueg(self, ctx, bases, vals, prefix_max, k):
        b = _as(bases, np.int32)
        v = _as(vals, np.uint32)
        _LIB.rce_ueg(self._h, _ptr(ctx, ctypes.c_uint16),
                     _ptr(b, ctypes.c_int32), _ptr(v, ctypes.c_uint32),
                     len(b), prefix_max, k)

    def occupancy(self, ctx, base_ctx, occ):
        b = _as(base_ctx, np.int32)
        o = _as(occ, np.uint8)
        _LIB.rce_occupancy(self._h, _ptr(ctx, ctypes.c_uint16),
                           _ptr(b, ctypes.c_int32), _ptr(o, ctypes.c_uint8),
                           len(b))

    def occupancy_sym(self, ctx, base_ctx, occ):
        b = _as(base_ctx, np.int32)
        o = _as(occ, np.uint8)
        _LIB.rce_occ_sym(self._h, _ptr(ctx, ctypes.c_uint16),
                         _ptr(b, ctypes.c_int32), _ptr(o, ctypes.c_uint8),
                         len(b))

    def occ_stream(self, ctx, occ_bytes, depth):
        """Encode a whole level-major occupancy byte stream in one
        native call; PARENT contexts are derived from the stream
        itself (entropy.cc rce_occ_stream).  Returns nodes consumed."""
        o = _as(occ_bytes, np.uint8)
        rc = _LIB.rce_occ_stream(self._h, _ptr(ctx, ctypes.c_uint16),
                                 _ptr(o, ctypes.c_uint8), len(o), depth)
        if rc != len(o):
            raise ValueError(
                f"occ_stream: inconsistent stream ({rc} != {len(o)})")
        return int(rc)

    def octree(self, ctx, leaf_codes_sorted, depth, mode,
               use_sym=False):
        """Full-tree occupancy coding in one native call (octree.cc).
        use_sym: ctx is bytewise Fenwick memory (new_sym_contexts)."""
        c = _as(leaf_codes_sorted, np.int64)
        return int(_LIB.oct_encode(
            self._h, _ptr(ctx, ctypes.c_uint16),
            _ptr(c, ctypes.c_int64), len(c), depth, mode,
            1 if use_sym else 0))

    def octree_inter(self, ctx, leaf_codes_sorted, depth, ref_codes,
                     use_sym=False):
        c = _as(leaf_codes_sorted, np.int64)
        r = _as(ref_codes, np.int64)
        return int(_LIB.oct_encode_inter(
            self._h, _ptr(ctx, ctypes.c_uint16),
            _ptr(c, ctypes.c_int64), len(c), depth,
            _ptr(r, ctypes.c_int64), len(r), 1 if use_sym else 0))

    def residuals(self, ctx, vals, prefix_max, k):
        v = _as(vals, np.int32)
        _LIB.rce_residuals(self._h, _ptr(ctx, ctypes.c_uint16),
                           _ptr(v, ctypes.c_int32), len(v), prefix_max, k)

    def zrun_residuals(self, ctx, vals, prefix_max, k):
        v = _as(vals, np.int32)
        _LIB.rce_zrun(self._h, _ptr(ctx, ctypes.c_uint16),
                      _ptr(v, ctypes.c_int32), len(v), prefix_max, k)

    def zrow_residuals(self, ctx, rows):
        r = np.ascontiguousarray(rows, dtype=np.int32)
        _LIB.rce_zrow(self._h, _ptr(ctx, ctypes.c_uint16),
                      _ptr(r, ctypes.c_int32), r.shape[0], r.shape[1])

    def resbl(self, ctx, vals):
        v = _as(vals, np.int32)
        _LIB.rce_resbl(self._h, _ptr(ctx, ctypes.c_uint16),
                       _ptr(v, ctypes.c_int32), len(v))

    def trisoup_verts(self, ctx, pres, vpos, nadj, prev1, prev2,
                      nbits):
        p = _as(pres, np.uint8)
        v = _as(vpos, np.int32)
        na = _as(nadj, np.int32)
        p1 = _as(prev1, np.int64)
        p2 = _as(prev2, np.int64)
        _LIB.rce_trisoup_verts(
            self._h, _ptr(ctx, ctypes.c_uint16),
            _ptr(p, ctypes.c_uint8), _ptr(v, ctypes.c_int32),
            _ptr(na, ctypes.c_int32), _ptr(p1, ctypes.c_int64),
            _ptr(p2, ctypes.c_int64), len(p), nbits)

    def trisoup_verts2(self, ctx, pres, vpos, order, nbr, orient,
                       cmult, nbefore, nafter, dirn, nbits):
        p = _as(pres, np.uint8)
        v = _as(vpos, np.int32)
        o = _as(order, np.int64)
        nb = _as(np.ascontiguousarray(nbr).reshape(-1), np.int32)
        orc = _as(orient, np.uint16)
        cm = _as(cmult, np.uint8)
        nbf = _as(nbefore, np.uint8)
        naf = _as(nafter, np.uint8)
        dr = _as(dirn, np.uint8)
        _LIB.rce_trisoup_verts2(
            self._h, _ptr(ctx, ctypes.c_uint16),
            _ptr(p, ctypes.c_uint8), _ptr(v, ctypes.c_int32),
            _ptr(o, ctypes.c_int64), _ptr(nb, ctypes.c_int32),
            _ptr(orc, ctypes.c_uint16), _ptr(cm, ctypes.c_uint8),
            _ptr(nbf, ctypes.c_uint8), _ptr(naf, ctypes.c_uint8),
            _ptr(dr, ctypes.c_uint8), len(p), nbits)

    def get_bytes(self):
        n = _LIB.rce_size(self._h)
        out = np.zeros(n, dtype=np.uint8)
        if n:
            _LIB.rce_copy(self._h, _ptr(out, ctypes.c_uint8))
        return out.tobytes()


class _NativeDecoder:
    def __init__(self, data: bytes):
        self._lib = _LIB
        self._buf = np.frombuffer(data, dtype=np.uint8).copy()
        self._h = _LIB.rcd_new(_ptr(self._buf, ctypes.c_uint8),
                               len(self._buf))

    def __del__(self):
        if getattr(self, "_h", None) and getattr(self, "_lib", None):
            self._lib.rcd_free(self._h)
            self._h = None

    def bits(self, ctx, ctx_ids):
        ids = _as(ctx_ids, np.int32)
        out = np.zeros(len(ids), dtype=np.uint8)
        _LIB.rcd_bits(self._h, _ptr(ctx, ctypes.c_uint16),
                      _ptr(ids, ctypes.c_int32), _ptr(out, ctypes.c_uint8),
                      len(ids))
        return out

    def bits_chain(self, ctx, n):
        """n bits with ctx id = previous decoded bit (ctx size 2)."""
        out = np.zeros(n, dtype=np.uint8)
        if n:
            _LIB.rcd_bits_chain(self._h, _ptr(ctx, ctypes.c_uint16),
                                _ptr(out, ctypes.c_uint8), n)
        return out

    def mode_chain(self, ctx, n):
        """n 2-bit symbols, ctx chained on previous symbol (size 8)."""
        out = np.zeros(n, dtype=np.uint8)
        if n:
            _LIB.rcd_mode_chain(self._h, _ptr(ctx, ctypes.c_uint16),
                                _ptr(out, ctypes.c_uint8), n)
        return out

    def bypass(self, nbits):
        n = _as(nbits, np.int32)
        out = np.zeros(len(n), dtype=np.uint32)
        _LIB.rcd_bypass(self._h, _ptr(out, ctypes.c_uint32),
                        _ptr(n, ctypes.c_int32), len(n))
        return out

    def ueg(self, ctx, bases, prefix_max, k):
        b = _as(bases, np.int32)
        out = np.zeros(len(b), dtype=np.uint32)
        _LIB.rcd_ueg(self._h, _ptr(ctx, ctypes.c_uint16),
                     _ptr(b, ctypes.c_int32), _ptr(out, ctypes.c_uint32),
                     len(b), prefix_max, k)
        return out

    def occupancy(self, ctx, base_ctx):
        b = _as(base_ctx, np.int32)
        out = np.zeros(len(b), dtype=np.uint8)
        _LIB.rcd_occupancy(self._h, _ptr(ctx, ctypes.c_uint16),
                           _ptr(b, ctypes.c_int32), _ptr(out, ctypes.c_uint8),
                           len(b))
        return out

    def occupancy_sym(self, ctx, base_ctx):
        b = _as(base_ctx, np.int32)
        out = np.zeros(len(b), dtype=np.uint8)
        _LIB.rcd_occ_sym(self._h, _ptr(ctx, ctypes.c_uint16),
                         _ptr(b, ctypes.c_int32), _ptr(out, ctypes.c_uint8),
                         len(b))
        return out

    def occ_stream(self, ctx, cap, depth):
        """Decode a whole level-major occupancy byte stream in one
        native call (entropy.cc rcd_occ_stream).  Returns the occ
        bytes of all levels; PARENT contexts derived on the fly."""
        out = np.zeros(max(cap, 1), dtype=np.uint8)
        n = int(_LIB.rcd_occ_stream(self._h,
                                    _ptr(ctx, ctypes.c_uint16),
                                    _ptr(out, ctypes.c_uint8),
                                    len(out), depth))
        if n < 0:
            raise ValueError(f"occ_stream decode exceeds capacity {cap}")
        return out[:n]

    def octree(self, ctx, cap, depth, mode, use_sym=False):
        """Full-tree occupancy decode -> sorted unique leaf codes."""
        out = np.zeros(max(cap, 1), dtype=np.int64)
        n = int(_LIB.oct_decode(
            self._h, _ptr(ctx, ctypes.c_uint16),
            _ptr(out, ctypes.c_int64), len(out), depth, mode,
            1 if use_sym else 0))
        if n < 0:
            raise ValueError(f"octree decode needs capacity {-n} > {cap}")
        return out[:n]

    def octree_inter(self, ctx, cap, depth, ref_codes,
                 use_sym=False):
        out = np.zeros(max(cap, 1), dtype=np.int64)
        r = _as(ref_codes, np.int64)
        n = int(_LIB.oct_decode_inter(
            self._h, _ptr(ctx, ctypes.c_uint16),
            _ptr(out, ctypes.c_int64), len(out), depth,
            _ptr(r, ctypes.c_int64), len(r), 1 if use_sym else 0))
        if n < 0:
            raise ValueError(f"octree decode needs capacity {-n} > {cap}")
        return out[:n]

    def residuals(self, ctx, n, prefix_max, k):
        out = np.zeros(n, dtype=np.int32)
        _LIB.rcd_residuals(self._h, _ptr(ctx, ctypes.c_uint16),
                           _ptr(out, ctypes.c_int32), n, prefix_max, k)
        return out

    def zrun_residuals(self, ctx, n, prefix_max, k):
        out = np.zeros(n, dtype=np.int32)
        _LIB.rcd_zrun(self._h, _ptr(ctx, ctypes.c_uint16),
                      _ptr(out, ctypes.c_int32), n, prefix_max, k)
        return out

    def zrow_residuals(self, ctx, n, ncomp):
        out = np.zeros((n, ncomp), dtype=np.int32)
        _LIB.rcd_zrow(self._h, _ptr(ctx, ctypes.c_uint16),
                      _ptr(out, ctypes.c_int32), n, ncomp)
        return out

    def resbl(self, ctx, n):
        out = np.zeros(n, dtype=np.int32)
        _LIB.rcd_resbl(self._h, _ptr(ctx, ctypes.c_uint16),
                       _ptr(out, ctypes.c_int32), n)
        return out

    def trisoup_verts(self, ctx, nadj, prev1, prev2, ne, nbits):
        pres = np.zeros(ne, dtype=np.uint8)
        vpos = np.zeros(ne, dtype=np.int32)
        na = _as(nadj, np.int32)
        p1 = _as(prev1, np.int64)
        p2 = _as(prev2, np.int64)
        _LIB.rcd_trisoup_verts(
            self._h, _ptr(ctx, ctypes.c_uint16),
            _ptr(pres, ctypes.c_uint8), _ptr(vpos, ctypes.c_int32),
            _ptr(na, ctypes.c_int32), _ptr(p1, ctypes.c_int64),
            _ptr(p2, ctypes.c_int64), ne, nbits)
        return pres, vpos

    def trisoup_verts2(self, ctx, order, nbr, orient, cmult, nbefore,
                       nafter, dirn, ne, nbits):
        pres = np.zeros(ne, dtype=np.uint8)
        vpos = np.zeros(ne, dtype=np.int32)
        o = _as(order, np.int64)
        nb = _as(np.ascontiguousarray(nbr).reshape(-1), np.int32)
        orc = _as(orient, np.uint16)
        cm = _as(cmult, np.uint8)
        nbf = _as(nbefore, np.uint8)
        naf = _as(nafter, np.uint8)
        dr = _as(dirn, np.uint8)
        _LIB.rcd_trisoup_verts2(
            self._h, _ptr(ctx, ctypes.c_uint16),
            _ptr(pres, ctypes.c_uint8), _ptr(vpos, ctypes.c_int32),
            _ptr(o, ctypes.c_int64), _ptr(nb, ctypes.c_int32),
            _ptr(orc, ctypes.c_uint16), _ptr(cm, ctypes.c_uint8),
            _ptr(nbf, ctypes.c_uint8), _ptr(naf, ctypes.c_uint8),
            _ptr(dr, ctypes.c_uint8), ne, nbits)
        return pres, vpos


def radix_sort(codes: np.ndarray, return_perm: bool = True):
    """Native radix sort of int64 Morton codes (octree.cc radix_sort64).

    Returns (sorted_codes, perm) — perm maps sorted order to original
    indices (same contract as np.argsort).  Falls back to numpy.
    """
    if _LIB is None:
        perm = np.argsort(codes, kind="stable")
        return codes[perm], (perm if return_perm else None)
    keys = np.ascontiguousarray(codes, dtype=np.int64).copy()
    perm = np.zeros(len(keys), dtype=np.int64) if return_perm else None
    _LIB.radix_sort64(
        _ptr(keys, ctypes.c_int64),
        _ptr(perm, ctypes.c_int64) if return_perm else None,
        len(keys))
    return keys, perm


def morton_sort(positions: np.ndarray, return_perm: bool = True):
    """Fused native Morton encode + radix sort of (N,3) int positions.

    Returns (sorted_codes, perm|None).  Falls back to numpy.
    """
    n = positions.shape[0]
    if _LIB is None or n == 0:
        from ..utils import morton as _m
        codes = _m.encode(positions.astype(np.int64))
        if return_perm:
            perm = np.argsort(codes, kind="stable")
            return codes[perm], perm
        return np.sort(codes), None
    xyz = np.ascontiguousarray(positions, dtype=np.int64)
    codes = np.empty(n, dtype=np.int64)
    perm = np.empty(n, dtype=np.int64) if return_perm else None
    _LIB.morton_sort(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        _ptr(codes, ctypes.c_int64),
        _ptr(perm, ctypes.c_int64) if return_perm else None)
    return codes, perm


def RangeEncoder(force_python: bool = False):
    """Factory: native encoder if available, else pure-Python."""
    if _LIB is not None and not force_python:
        return _NativeEncoder()
    return _PyEncoder()


def RangeDecoder(data: bytes, force_python: bool = False):
    if _LIB is not None and not force_python:
        return _NativeDecoder(data)
    return _PyDecoder(data)
