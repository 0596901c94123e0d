"""ctypes bindings to the port's host rANS library.

Counterpart of learned_pmctf_tpu/native.py over the port's own copy of
the C++ coder (``csrc/rans/``). The library is built with g++ at first
use into ``learned_pmctf_tpu_torch/build/libpmctf_rans.so`` and rebuilt
when a source is newer than it. The build writes a file of its own and
renames it into place, so processes that build at once do not race. A
failed build raises: there is no fallback, not even for
``pmf_to_quantized_cdf``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_PKG, "csrc", "rans", name)
                for name in ("rans_lib.cpp", "rans_core.h"))
BUILD_DIR = os.path.join(_PKG, "build")
LIBRARY = os.path.join(BUILD_DIR, "libpmctf_rans.so")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pedantic",
             "-Werror", "-pthread", "-shared")

_lib = None
_lock = threading.Lock()


def build(force: bool = False) -> str:
    """Compile csrc/rans into build/libpmctf_rans.so if it is missing or
    older than a source. Returns g++'s output ('' if up to date)."""
    newest = max(os.path.getmtime(p) for p in SOURCES)
    if (not force and os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= newest):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCES[0]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on the rANS "
                               f"library:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(LIBRARY)
        c_i16p = ctypes.POINTER(ctypes.c_int16)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_int, c_void = ctypes.c_int, ctypes.c_void_p
        for name, args, res in (
                ("pmctf_encoder_create", [c_int, c_int], c_void),
                ("pmctf_encoder_destroy", [c_void], None),
                ("pmctf_encoder_encode_with_indexes",
                 [c_void, c_i16p, c_i16p, c_int, c_i32p, c_int, c_int,
                  c_i32p, c_i32p], None),
                ("pmctf_encoder_flush", [c_void], None),
                ("pmctf_encoder_stream_size", [c_void], c_int),
                ("pmctf_encoder_get_stream", [c_void, c_u8p], None),
                ("pmctf_encoder_reset", [c_void], None),
                ("pmctf_decoder_create", [c_int], c_void),
                ("pmctf_decoder_destroy", [c_void], None),
                ("pmctf_decoder_set_stream", [c_void, c_u8p, c_int], None),
                ("pmctf_decoder_decode_stream",
                 [c_void, c_i16p, c_int, c_i32p, c_int, c_int, c_i32p, c_i32p,
                  c_i16p], None),
                ("pmctf_pmf_to_quantized_cdf",
                 [ctypes.POINTER(ctypes.c_float), c_int, c_int,
                  ctypes.POINTER(ctypes.c_uint32)], c_int)):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _lib = lib
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _tables(cdfs, cdfs_sizes, offsets):
    cdfs = np.ascontiguousarray(cdfs, dtype=np.int32)
    if cdfs.ndim != 2:
        raise ValueError(f"cdfs must be a 2-D table, got {cdfs.shape}")
    sizes = np.ascontiguousarray(cdfs_sizes, dtype=np.int32)
    offs = np.ascontiguousarray(offsets, dtype=np.int32)
    if sizes.shape != (cdfs.shape[0],) or offs.shape != (cdfs.shape[0],):
        raise ValueError("cdfs_sizes and offsets need one entry per cdf row")
    return cdfs, sizes, offs


class RansEncoder:
    """Buffering multi-substream rANS encoder (host side)."""

    def __init__(self, multithread: bool = False, stream_part: int = 1):
        self._lib = _load()
        self._h = self._lib.pmctf_encoder_create(int(multithread), int(stream_part))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pmctf_encoder_destroy(self._h)
            self._h = None

    def encode_with_indexes(self, symbols, indexes, cdfs, cdfs_sizes, offsets):
        symbols = np.ascontiguousarray(symbols, dtype=np.int16).reshape(-1)
        indexes = np.ascontiguousarray(indexes, dtype=np.int16).reshape(-1)
        if symbols.size != indexes.size:
            raise ValueError(f"{symbols.size} symbols, {indexes.size} indexes")
        cdfs, sizes, offs = _tables(cdfs, cdfs_sizes, offsets)
        self._lib.pmctf_encoder_encode_with_indexes(
            self._h, _ptr(symbols, ctypes.c_int16), _ptr(indexes, ctypes.c_int16),
            symbols.size, _ptr(cdfs, ctypes.c_int32), cdfs.shape[0],
            cdfs.shape[1], _ptr(sizes, ctypes.c_int32), _ptr(offs, ctypes.c_int32))

    def flush(self):
        self._lib.pmctf_encoder_flush(self._h)

    def get_encoded_stream(self) -> bytes:
        size = self._lib.pmctf_encoder_stream_size(self._h)
        out = np.empty(size, dtype=np.uint8)
        self._lib.pmctf_encoder_get_stream(self._h, _ptr(out, ctypes.c_uint8))
        return out.tobytes()

    def reset(self):
        self._lib.pmctf_encoder_reset(self._h)


class RansDecoder:
    """Multi-substream rANS decoder (host side)."""

    def __init__(self, stream_part: int = 1):
        self._lib = _load()
        self._h = self._lib.pmctf_decoder_create(int(stream_part))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pmctf_decoder_destroy(self._h)
            self._h = None

    def set_stream(self, stream: bytes):
        """Load a stream (the library copies it)."""
        if not stream:
            raise ValueError("empty rANS stream")
        data = np.frombuffer(stream, dtype=np.uint8)
        self._lib.pmctf_decoder_set_stream(
            self._h, _ptr(data, ctypes.c_uint8), data.size)

    def decode_stream(self, indexes, cdfs, cdfs_sizes, offsets) -> np.ndarray:
        indexes = np.ascontiguousarray(indexes, dtype=np.int16).reshape(-1)
        cdfs, sizes, offs = _tables(cdfs, cdfs_sizes, offsets)
        out = np.empty(indexes.size, dtype=np.int16)
        self._lib.pmctf_decoder_decode_stream(
            self._h, _ptr(indexes, ctypes.c_int16), indexes.size,
            _ptr(cdfs, ctypes.c_int32), cdfs.shape[0], cdfs.shape[1],
            _ptr(sizes, ctypes.c_int32), _ptr(offs, ctypes.c_int32),
            _ptr(out, ctypes.c_int16))
        return out


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    """Float PMF -> integer CDF summing to 2^precision, all buckets >= 1
    (the native library; a failed build raises)."""
    pmf = np.ascontiguousarray(pmf, dtype=np.float32).reshape(-1)
    out = np.empty(pmf.size + 1, dtype=np.uint32)
    rc = _load().pmctf_pmf_to_quantized_cdf(
        _ptr(pmf, ctypes.c_float), pmf.size, precision, _ptr(out, ctypes.c_uint32))
    if rc != 0:
        raise ValueError(f"pmf_to_quantized_cdf failed with code {rc}")
    return out.astype(np.int32)


def pmf_to_quantized_cdf_plain(pmf, precision: int = 16) -> np.ndarray:
    """Numpy version of ``pmf_to_quantized_cdf`` with the same numerics;
    the tests hold the native one against it. It rounds half away from
    zero, as ``std::round`` does (``np.round`` rounds half to even, and
    pmf * 2^16 is exactly k + 0.5 for some f32 pmfs)."""
    pmf = np.asarray(pmf, dtype=np.float32).reshape(-1)
    n = pmf.size
    scaled = pmf.astype(np.float64) * (1 << precision)
    rounded = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    cdf = np.zeros(n + 1, dtype=np.uint64)
    cdf[1:] = np.maximum(rounded + 0.5, 0).astype(np.uint64)
    total = int(cdf.sum())
    if total == 0:
        raise ValueError("zero-mass pmf")
    cdf = ((1 << precision) * cdf) // total
    cdf = np.cumsum(cdf).astype(np.int64)
    cdf[-1] = 1 << precision
    for i in range(n):
        if cdf[i] == cdf[i + 1]:
            freqs = cdf[1:] - cdf[:-1]
            candidates = np.where(freqs > 1)[0]
            if candidates.size == 0:
                raise ValueError("cannot steal frequency")
            best_steal = candidates[np.argmin(freqs[candidates])]
            if best_steal < i:
                cdf[best_steal + 1:i + 1] -= 1
            else:
                cdf[i + 1:best_steal + 1] += 1
    if cdf[0] != 0 or cdf[-1] != (1 << precision) or np.any(cdf[1:] <= cdf[:-1]):
        raise ValueError("quantized cdf is not strictly increasing to 2^precision")
    return cdf.astype(np.int32)
