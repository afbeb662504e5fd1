"""ctypes bindings for the C++ entropy codec (built lazily with g++).

The native codec exposes a small C ABI (see native/entropy.cpp) loaded
through ctypes.  The shared object is compiled from the committed source on
first use into the checkout's gitignored ``build/`` directory, keyed by a
source hash.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from typing import Optional

import numpy as np

from ..config import BadRleCodeError, BadStreamError

_SRC = os.path.join(os.path.dirname(__file__), "native", "entropy.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build")
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    return os.path.join(_BUILD_DIR, f"entropy_{digest}.so")


def _build() -> Optional[ctypes.CDLL]:
    global _build_error
    so = _so_path()
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               "-fno-exceptions", "-o", tmp, _SRC]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, so)
        except (subprocess.CalledProcessError, OSError) as e:
            _build_error = getattr(e, "stderr", str(e)) or str(e)
            print(f"jpeg_tpu: native entropy codec build failed; "
                  f"falling back to NumPy codec:\n{_build_error}",
                  file=sys.stderr)
            return None
    lib = ctypes.CDLL(so)
    lib.jt_encode.restype = ctypes.c_int64
    lib.jt_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_void_p, ctypes.c_int64]
    lib.jt_encode_bound.restype = ctypes.c_int64
    lib.jt_encode_bound.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.jt_decode.restype = ctypes.c_int64
    lib.jt_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.jt_scan_offsets.restype = ctypes.c_int64
    lib.jt_scan_offsets.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int64]
    return lib


def available() -> bool:
    global _lib
    if _lib is None and _build_error is None:
        _lib = _build()
    return _lib is not None


def encode_levels(levels: np.ndarray) -> bytes:
    assert available()
    levels = np.ascontiguousarray(levels, dtype=np.int32)
    n, L = levels.shape
    cap = int(_lib.jt_encode_bound(n, L))
    out = np.empty(cap, dtype=np.uint8)
    res = _lib.jt_encode(levels.ctypes.data, n, L, out.ctypes.data, cap)
    if res == -2:
        raise BadRleCodeError(
            f"amplitude exceeds {1 << 14} - 1 (size > 15)")
    if res < 0:
        raise RuntimeError(f"native encode failed with code {res}")
    return out[:res].tobytes()


def _raise_stream_error(res: int, buf_size: int, num_blocks: int) -> None:
    if res == -3:
        raise BadRleCodeError("invalid code: nonzero run with size 0")
    if res == -4:
        raise BadStreamError("coefficient index overflows block")
    if res == -5:
        raise BadStreamError("truncated stream")
    if res == -6:
        raise BadStreamError("block did not terminate with EOB")
    if res < 0:
        raise RuntimeError(f"native codec failed with code {res}")
    if res != buf_size:
        raise BadStreamError(
            f"stream has {buf_size - res} trailing bytes after "
            f"{num_blocks} blocks")


def scan_offsets(data: bytes, num_blocks: int, L: int) -> np.ndarray:
    """Validate the stream and return each block's start byte offset.

    The serial O(bytes) part of decode; everything per-coefficient can then
    run block-parallel (consumed by the device decoder)."""
    assert available()
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    starts = np.zeros(num_blocks, dtype=np.int32)
    res = _lib.jt_scan_offsets(buf.ctypes.data if buf.size else None,
                               buf.size, starts.ctypes.data, num_blocks, L)
    _raise_stream_error(res, buf.size, num_blocks)
    return starts


def decode_levels(data: bytes, num_blocks: int, L: int) -> np.ndarray:
    assert available()
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    out = np.zeros((num_blocks, L), dtype=np.int32)
    res = _lib.jt_decode(buf.ctypes.data if buf.size else None, buf.size,
                         out.ctypes.data, num_blocks, L)
    if res == -3:
        raise BadRleCodeError("invalid code: nonzero run with size 0")
    if res == -4:
        raise BadStreamError("coefficient index overflows block")
    if res == -5:
        raise BadStreamError("truncated stream")
    if res == -6:
        raise BadStreamError("block did not terminate with EOB")
    if res < 0:
        raise RuntimeError(f"native decode failed with code {res}")
    if res != buf.size:
        raise BadStreamError(
            f"stream has {buf.size - res} trailing bytes after "
            f"{num_blocks} blocks")
    return out
