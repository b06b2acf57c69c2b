"""ctypes binding for the native fastio runtime (native/fastio.cpp; this
package's own copy of nicer_slam_tpu/utils/fastio.py).

Multi-threaded xz/.npy decoding + an async prefetch pool — the native
replacement for the reference's main-thread lzma reads
(scene_dataset.py:141-212). Falls back to pure-Python lzma transparently
when the shared library hasn't been built (native/build.sh).
"""

from __future__ import annotations

import ctypes
import io
import os
from typing import Dict, Optional

import numpy as np

_LIB = None
_LIB_TRIED = False


def _load_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "native", "libfastio.so")
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.fastio_decode_file.restype = ctypes.c_int64
    lib.fastio_decode_file.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_uint8),
                                       ctypes.c_int64]
    lib.fastio_pool_create.restype = ctypes.c_void_p
    lib.fastio_pool_create.argtypes = [ctypes.c_int]
    lib.fastio_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.fastio_pool_submit.restype = ctypes.c_int64
    lib.fastio_pool_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fastio_pool_collect.restype = ctypes.c_int64
    lib.fastio_pool_collect.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.POINTER(ctypes.c_uint8),
                                        ctypes.c_int64]
    _LIB = lib
    return lib


def available() -> bool:
    return _load_lib() is not None


def reload() -> bool:
    """Re-attempt loading the shared library (e.g. after building it)."""
    global _LIB, _LIB_TRIED
    _LIB, _LIB_TRIED = None, False
    return available()


def _npy_from_bytes(buf: bytes) -> np.ndarray:
    return np.load(io.BytesIO(buf), allow_pickle=False)


def load_npy(path: str, max_bytes: int = 256 << 20) -> np.ndarray:
    """Decode an (optionally xz-compressed) .npy file natively."""
    lib = _load_lib()
    if lib is None:
        from ..datasets.scene_dataset import load_npy_maybe_lzma

        return load_npy_maybe_lzma(path)
    out = np.empty(max_bytes, np.uint8)
    n = lib.fastio_decode_file(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        max_bytes)
    if n < 0:
        raise IOError(f"fastio failed to decode {path}")
    return _npy_from_bytes(out[:n].tobytes())


class PrefetchPool:
    """Async multi-threaded decoder: submit paths now, collect arrays later
    (overlaps disk+xz with device compute)."""

    def __init__(self, threads: int = 8):
        self._lib = _load_lib()
        self._pool = (self._lib.fastio_pool_create(threads)
                      if self._lib is not None else None)
        self._fallback: Dict[int, str] = {}
        self._next = 0

    def submit(self, path: str) -> int:
        if self._pool is None:
            jid = self._next
            self._next += 1
            self._fallback[jid] = path
            return jid
        return self._lib.fastio_pool_submit(self._pool, path.encode())

    def collect_npy(self, job_id: int, max_bytes: int = 256 << 20) -> np.ndarray:
        if self._pool is None:
            from ..datasets.scene_dataset import load_npy_maybe_lzma

            return load_npy_maybe_lzma(self._fallback.pop(job_id))
        out = np.empty(max_bytes, np.uint8)
        n = self._lib.fastio_pool_collect(
            self._pool, job_id,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_bytes)
        if n < 0:
            raise IOError(f"fastio job {job_id} failed")
        return _npy_from_bytes(out[:n].tobytes())

    def close(self):
        if self._pool is not None:
            self._lib.fastio_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
