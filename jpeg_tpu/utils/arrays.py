"""Reference-named array utilities (drop-in surface for util.py:1-113).

Users of the reference import ``pad_array`` / ``split_into_blocks`` / ... by
name; these wrappers expose the same names and call signatures over the
vectorized implementations in :mod:`jpeg_tpu.ops.blocks` (jnp,
returning NumPy arrays for host callers).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import (BadArrayShapeError, EmptyArrayError,  # noqa: F401
                      padded_size)
from ..ops import blocks as B


def pad_array(a, factor: int) -> np.ndarray:
    """Edge-replicate pad both dims up to a multiple of ``factor``
    (reference util.py:17-41, minus the O(pad) copy loop)."""
    return np.asarray(B.pad_edge(jnp.asarray(a), factor))


def undo_pad_array(a, padding) -> np.ndarray:
    """Remove ``(rows, cols)`` of trailing padding (reference util.py:44-47)."""
    ph, pw = padding
    h, w = a.shape[0] - ph, a.shape[1] - pw
    return np.asarray(a)[:h, :w]


def split_into_blocks(a, block_size: int) -> np.ndarray:
    """(H, W) -> (H/b, W/b, b, b), padding first if needed
    (reference util.py:55-89 without the Python loops)."""
    return np.asarray(B.blockify(jnp.asarray(a), block_size))


def extract_nth_block(blocks_column, block_size: int, n: int) -> np.ndarray:
    """n-th block of a stacked block column (reference util.py:50-52)."""
    i = n * block_size
    return np.asarray(blocks_column)[i:i + block_size]


def block_columns(a, block_size: int):
    """Yield (column_index, stacked blocks of that column)
    (reference util.py:55-65)."""
    a = np.asarray(a)
    height, width = a.shape
    a = a.reshape((height * width // block_size, block_size))
    stride = width // block_size
    for j in range(stride):
        yield j, a[j::stride]


def inflate(a, factor: int) -> np.ndarray:
    """Nearest-neighbour upsample by ``factor`` (reference util.py:6-14)."""
    return np.asarray(B.inflate(jnp.asarray(a), factor))


def calculate_padding(a, factor: int):
    """(pad_rows, pad_cols) to reach multiples of ``factor``
    (reference util.py:104-108)."""
    return (padded_size(a.shape[0], factor) - a.shape[0],
            padded_size(a.shape[1], factor) - a.shape[1])


def band_to_array(band) -> np.ndarray:
    """PIL band -> 2-D int array (reference util.py:110-112, which built it
    from ``list(band.getdata())``; np.asarray is the zero-copy form)."""
    a = np.asarray(band)
    if a.ndim != 2:
        raise BadArrayShapeError(a.shape)
    return a.astype(np.int64)
