"""Quantizers as pure elementwise functions over zigzag-ordered coefficients.

The reference applies quantizers blockwise on 2-D ``d x d`` blocks *before*
the zigzag reorder (reference: pipeline/quantization.py, quantizers.py).  All
four quantizers are elementwise (or a static per-position mask/table), so they
commute with the zigzag permutation: we apply them *after* the fused
DCT+zigzag matmul, using zigzag-permuted tables/masks.  XLA fuses this into
the matmul epilogue, so it costs nothing.

Semantics matched exactly:
  * 'none'    round(a)                       (quantizers.py:4-9)
  * 'discard' round(a), zero rows/cols>=keep (quantizers.py:12-20)
  * 'divide'  round(a / float(divisor)); restore a * divisor
              (quantizers.py:23-31)
  * 'qtable'  round(a * (1.0/q)); restore round(a * q), 8x8 only
              (quantizers.py:34-53)
``round`` is round-half-to-even, matching ``np.round``.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from ..config import QuantizationMethod
from .transform import zigzag_permutation

MAX_AMP = (1 << 14) - 1  # largest codable |amplitude| (util.py:162-174)

#: Standard JPEG luminance quantization table hardcoded by the reference
#: (quantizers.py:35-42).
JPEG_QTABLE = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61],
     [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56],
     [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77],
     [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float64)


@functools.lru_cache(maxsize=None)
def qtable_zigzag(n: int = 8) -> np.ndarray:
    """JPEG table flattened in zigzag order (n must be 8)."""
    assert n == 8
    return JPEG_QTABLE.reshape(-1)[zigzag_permutation(n)]


@functools.lru_cache(maxsize=None)
def discard_mask_zigzag(n: int, keep: int) -> np.ndarray:
    """1.0 where block row < keep and col < keep, else 0.0; zigzag order."""
    rows = np.arange(n)[:, None]
    cols = np.arange(n)[None, :]
    mask = ((rows < keep) & (cols < keep)).astype(np.float64)
    return mask.reshape(-1)[zigzag_permutation(n)]


def quantize(coeffs_zz, method: QuantizationMethod, dct_size: int):
    """Elementwise quantization of zigzag coefficients (float -> float)."""
    name = method.name
    if name == "none":
        return jnp.round(coeffs_zz)
    if name == "discard":
        mask = jnp.asarray(discard_mask_zigzag(dct_size, method.keep),
                           dtype=coeffs_zz.dtype)
        return jnp.round(coeffs_zz) * mask
    if name == "divide":
        div = jnp.asarray(float(method.divisor), dtype=coeffs_zz.dtype)
        if coeffs_zz.dtype == jnp.float64:
            # Same jit-only trap as blocks.subsample: XLA rewrites division
            # by a constant into a reciprocal multiply (1 ULP off), flipping
            # round() at half-integer quotients.  Hide the constant so true
            # IEEE division is emitted in parity mode.
            import jax
            div = jax.lax.optimization_barrier(div)
        return jnp.round(coeffs_zz / div)
    if name == "qtable":
        inv_q = jnp.asarray(1.0 / qtable_zigzag(dct_size),
                            dtype=coeffs_zz.dtype)
        return jnp.round(coeffs_zz * inv_q)
    raise ValueError(name)


class RoundingQuantizer:
    """Drop-in class surface (reference quantizers.py:4-9); vectorized."""

    def quantize(self, a):
        return np.round(a)

    def restore(self, a):
        return a


class DiscardingQuantizer(RoundingQuantizer):
    """Zero all rows/cols >= keep (reference quantizers.py:12-20)."""

    def __init__(self, keep: int = 2):
        self.keep = keep

    def quantize(self, a):
        res = np.round(np.asarray(a)).copy()
        res[self.keep:] = 0
        res[:, self.keep:] = 0
        return res


class DivisionQuantizer(RoundingQuantizer):
    """round(a / divisor); restore a * divisor (quantizers.py:23-31)."""

    def __init__(self, divisor: float = 40):
        self.divisor = divisor

    def quantize(self, a):
        return np.round(np.asarray(a) / float(self.divisor))

    def restore(self, a):
        return np.asarray(a) * self.divisor


class JpegQuantizationTable(RoundingQuantizer):
    """Standard 8x8 luminance table (quantizers.py:34-53)."""

    table = JPEG_QTABLE

    def quantize(self, a):
        return np.round(np.asarray(a) * (1.0 / JPEG_QTABLE))

    def restore(self, a):
        return np.round(np.asarray(a) * JPEG_QTABLE)


#: Scheme name -> quantizer class (reference pipeline/__init__.py:14-19).
QUANTIZER_CLASSES = {
    "none": RoundingQuantizer,
    "discard": DiscardingQuantizer,
    "divide": DivisionQuantizer,
    "qtable": JpegQuantizationTable,
}


def quantizer_for(method: QuantizationMethod):
    """Instantiate the classic quantizer object for a QuantizationMethod."""
    return QUANTIZER_CLASSES[method.name](**method.params)


def epilogue_vectors(method: QuantizationMethod, dct_size: int):
    """(mul, div, mask) f64 vectors s.t. quantize == round(c*mul/div)*mask.

    The factored elementwise form consumed by the f64 parity oracle
    (utils/parity.py); exactly mirrors :func:`quantize`.
    """
    L = dct_size * dct_size
    mul = np.ones(L)
    div = np.ones(L)
    mask = np.ones(L)
    name = method.name
    if name == "discard":
        mask = discard_mask_zigzag(dct_size, method.keep)
    elif name == "divide":
        div = float(method.divisor) * mul
    elif name == "qtable":
        mul = 1.0 / qtable_zigzag(dct_size)
    elif name != "none":
        raise ValueError(name)
    return mul, div, mask


def dequantize(levels_zz, method: QuantizationMethod, dct_size: int):
    """Inverse ('restore') step on integer levels; returns integer dtype.

    The reference's decode path stores restored values back into an int array
    (pipeline/quantization.py:20-30 with dtype from RLE decode), so non-int
    results are truncated toward zero — reproduced here for float divisors.
    """
    name = method.name
    if name in ("none", "discard"):
        return levels_zz
    if name == "divide":
        import jax
        d = method.divisor
        x64 = jax.config.jax_enable_x64
        if float(d) == int(d):
            if x64 or int(d) <= (2 ** 31 - 1) // MAX_AMP:
                return levels_zz * jnp.asarray(int(d), dtype=levels_zz.dtype)
            # Fast mode with a product that could wrap int32: compute in
            # f32 (feeds a f32 IDCT anyway; no wrap, ~1 ULP of f64 parity).
            return levels_zz.astype(jnp.float32) * float(d)
        # Reference semantics: trunc of the float product
        # (pipeline/quantization.py stores into the int levels array).
        ftype = jnp.float64 if x64 else jnp.float32
        prod = jnp.trunc(levels_zz.astype(ftype) * float(d))
        return prod.astype(levels_zz.dtype) if x64 else prod
    if name == "qtable":
        q = jnp.asarray(qtable_zigzag(dct_size).astype(np.int64),
                        dtype=levels_zz.dtype)
        return levels_zz * q
    raise ValueError(name)
