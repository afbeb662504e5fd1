"""Entropy coding: run-length + bitstream pack/unpack.

Backends:
  * ``native``  — C++ codec (ctypes), fastest; built lazily from
    ``jpeg_tpu/entropy/native/entropy.cpp``.
  * ``numpy``   — fully vectorized NumPy codec; always available.

``encode_levels`` / ``decode_levels`` pick the best available backend.
"""
from __future__ import annotations

import os
import threading

import numpy as np

from . import numpy_codec
from .numpy_codec import MAX_AMP, MAX_RUN, MAX_SIZE

_native = None
_native_checked = False


def _get_native():
    global _native, _native_checked
    if not _native_checked:
        _native_checked = True
        if os.environ.get("JPEG_TPU_NO_NATIVE"):
            _native = None
        else:
            try:
                from . import native_codec
                _native = native_codec if native_codec.available() else None
            except Exception:
                _native = None
    return _native


def encode_levels(levels: np.ndarray) -> bytes:
    levels = np.asarray(levels)
    if levels.dtype.kind not in "iu":
        raise TypeError(f"levels must be integer, got {levels.dtype}")
    wide = (levels.dtype.itemsize > 4
            or (levels.dtype.kind == "u" and levels.dtype.itemsize >= 4))
    # Validate BEFORE the int32 narrowing below — a wrapped value would
    # otherwise encode a valid-looking but wrong stream.  Range test, not
    # np.abs: |int64 min| overflows abs.
    if levels.size and wide and ((levels > MAX_AMP) | (levels < -MAX_AMP)).any():
        from ..config import BadRleCodeError
        raise BadRleCodeError(
            f"amplitude magnitude exceeds {MAX_AMP}: "
            f"range [{levels.min()}, {levels.max()}]")
    levels = np.ascontiguousarray(levels, dtype=np.int32)
    nat = _get_native()
    if nat is not None:
        return nat.encode_levels(levels)
    return numpy_codec.encode_levels(levels)


def decode_levels(data: bytes, num_blocks: int, L: int) -> np.ndarray:
    nat = _get_native()
    if nat is not None:
        # A thread-parallel range decode (scan + jt_decode_range on a pool)
        # was measured and removed: the boundary scan is ~75% of a full
        # decode with the word-window bit reader, so Amdahl caps the win
        # below the thread overhead.  Bands already decode in parallel at
        # the caller.
        return nat.decode_levels(data, num_blocks, L)
    return numpy_codec.decode_levels(data, num_blocks, L)


_warned_python_scan = False
_warn_lock = threading.Lock()


def scan_offsets(data: bytes, num_blocks: int, L: int) -> np.ndarray:
    """Validate a band stream and return each block's start byte offset.

    The serial O(bytes) prelude to block-parallel decode (device bit parsing
    consumes the offsets).  C++ scanner when available, else the pure-Python
    word-window scanner — so device decode works without a compiler.
    """
    from .device_scan import scan_mode
    if scan_mode() == "device":
        # JPEG_TPU_SCAN=device (entropy/device_scan.py:scan_mode):
        # speculative per-byte parse + orbit chase on the accelerator
        # (identical results/errors).
        from .device_scan import scan_offsets_hybrid
        return scan_offsets_hybrid(data, num_blocks, L)
    nat = _get_native()
    if nat is not None:
        return nat.scan_offsets(data, num_blocks, L)
    global _warned_python_scan
    if len(data) > (1 << 20):
        # Lock: scan_offsets runs concurrently on band threads
        # (api._start_decompress), so check-then-set alone can double-warn.
        with _warn_lock:
            fire, _warned_python_scan = not _warned_python_scan, True
    else:
        fire = False
    if fire:
        import warnings
        warnings.warn(
            "entropy: C++ scanner unavailable — falling back to the "
            "pure-Python boundary scan (one interpreted step per code; "
            "expect seconds of host time per multi-MP image). Install a "
            "C++ compiler or unset JPEG_TPU_NO_NATIVE for the fast path.",
            RuntimeWarning, stacklevel=2)
    return numpy_codec.scan_offsets(data, num_blocks, L)
