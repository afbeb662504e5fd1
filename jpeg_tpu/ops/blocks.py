"""Pixel-domain array ops: edge padding, mean-pool subsampling, blockify.

Vectorized replacements for the reference's per-block Python loops
(reference: util.py:17-89, pipeline/padding.py, pipeline/subsampling.py,
pipeline/dct_padding.py).  All functions are pure, shape-static, and safe
inside ``jax.jit``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import BadArrayShapeError, EmptyArrayError, padded_size


def _check_2d(a) -> None:
    if a.ndim != 2:
        raise BadArrayShapeError(a.shape)
    if a.shape[0] == 0 or a.shape[1] == 0:
        raise EmptyArrayError()


def pad_edge(a, factor: int):
    """Pad a 2-D array up to a multiple of ``factor`` by edge replication.

    Matches reference util.py:17-41 (repeat last row/column), but as one
    ``jnp.pad(mode='edge')`` instead of O(pad) array copies.
    """
    _check_2d(a)
    ph = padded_size(a.shape[0], factor) - a.shape[0]
    pw = padded_size(a.shape[1], factor) - a.shape[1]
    if ph == 0 and pw == 0:
        return a
    return jnp.pad(a, ((0, ph), (0, pw)), mode="edge")


def crop(a, height: int, width: int):
    """Inverse of :func:`pad_edge` given the target dims (util.py:44-47)."""
    return a[:height, :width]


def subsample(a, block_size: int):
    """Mean-pool over ``block_size`` x ``block_size`` tiles.

    The reference applies this to all three bands including luma
    (pipeline/subsampling.py:9-11).  Output is floating point (mean).
    """
    _check_2d(a)
    h, w = a.shape
    if h % block_size or w % block_size:
        a = pad_edge(a, block_size)
        h, w = a.shape
    dtype = jnp.result_type(a.dtype, jnp.float32)
    a = a.reshape(h // block_size, block_size, w // block_size, block_size)
    # Sum-then-divide, not jnp.mean: mean lowers to a reciprocal multiply,
    # which differs from np.mean's true division by 1 ULP for non-power-of-2
    # block areas — enough to flip round() at the DCT's half-integer
    # coefficients downstream.  Integer pixel sums are exact in f64, so the
    # single division makes subsampling bitwise equal to the reference
    # (subsampling.py:9-11).
    total = jnp.sum(a.astype(dtype), axis=(1, 3))
    denom = jnp.asarray(block_size * block_size, dtype)
    if dtype == jnp.float64:
        # Under jit XLA's algebraic simplifier rewrites division by a
        # constant into a reciprocal multiply (verified: 1-ULP drift vs
        # eager/NumPy).  The barrier hides the constant so true IEEE
        # division is emitted — required for bit parity.
        denom = jax.lax.optimization_barrier(denom)
    return total / denom


def subsample_fast(a, block_size: int):
    """f32 fast-path mean-pool with a FIXED evaluation order.

    Explicit left-associated strided adds — rows first, then columns —
    then a reciprocal multiply.  Subsampling runs *before* the transform
    (ops/band.py dispatches here and then runs the separable
    contraction), so pinning the add order here keeps the f32 result
    independent of how the backend schedules the pooling.  Parity (f64) mode keeps :func:`subsample`'s
    sum-then-true-divide, which matches the reference bitwise; the f32
    path never promises reference bit parity.

    Row-then-column 1-D strided slices, NOT the 2-D strided slice per
    (bi, bj) phase, which a compiler may lower to a gather-grade relayout
    (same values up to f32 add order, which this function pins either
    way).
    """
    _check_2d(a)
    return subsample_fast_hw(a, block_size)


def pad_edge_hw(a, factor: int):
    """:func:`pad_edge` on the LAST TWO axes (batch-polymorphic)."""
    if a.ndim == 2:
        return pad_edge(a, factor)
    ph = padded_size(a.shape[-2], factor) - a.shape[-2]
    pw = padded_size(a.shape[-1], factor) - a.shape[-1]
    if ph == 0 and pw == 0:
        return a
    return jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(0, ph), (0, pw)],
                   mode="edge")


def subsample_fast_hw(a, block_size: int):
    """:func:`subsample_fast` on the LAST TWO axes (batch-polymorphic);
    identical fixed evaluation order, so 2-D calls are bit-identical.

    See :func:`subsample_fast` for why the pooling is rows-then-columns
    with 1-D strided slices only."""
    h, w = a.shape[-2:]
    if h % block_size or w % block_size:
        a = pad_edge_hw(a, block_size)
    x = a.astype(jnp.float32)
    bs = block_size
    rows = x[..., 0::bs, :]
    for bi in range(1, bs):
        rows = rows + x[..., bi::bs, :]
    acc = rows[..., :, 0::bs]
    for bj in range(1, bs):
        acc = acc + rows[..., :, bj::bs]
    return acc * jnp.float32(1.0 / (bs * bs))


def inflate(a, factor: int):
    """Nearest-neighbour upsample; inverse of :func:`subsample`
    (reference util.py:6-14)."""
    return jnp.repeat(jnp.repeat(a, factor, axis=0), factor, axis=1)


def blockify(a, block_size: int):
    """(H, W) -> (H//b, W//b, b, b) without data-dependent loops
    (replaces reference util.py:55-89)."""
    _check_2d(a)
    h, w = a.shape
    if h % block_size or w % block_size:
        a = pad_edge(a, block_size)
        h, w = a.shape
    nv, nh = h // block_size, w // block_size
    return a.reshape(nv, block_size, nh, block_size).transpose(0, 2, 1, 3)


def deblockify(blocks):
    """(NV, NH, b, b) -> (NV*b, NH*b); inverse of :func:`blockify`."""
    nv, nh, b, b2 = blocks.shape
    assert b == b2
    return blocks.transpose(0, 2, 1, 3).reshape(nv * b, nh * b)
