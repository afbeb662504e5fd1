"""Fused per-band coefficient pipeline (pixels <-> quantized zigzag levels).

Everything between raw pixels and integer entropy-coder levels runs as
ONE jitted function per direction —
pad -> subsample -> pad -> blockify -> (DCT+zigzag matmul) -> quantize ->
int cast, and its exact inverse.  It replaces reference pipeline steps 0-6
(pipeline/padding.py, subsampling.py, dct_padding.py, normalization.py,
basis_change.py, quantization.py, zigzag_order.py), whose per-block Python
loops become batched tensor ops that XLA fuses around a single matmul.

Functions are cached per static config signature so repeated calls reuse the
compiled executable.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Configuration, QuantizationMethod
from . import blocks as B
from . import quantize as Q
from . import transform as T


def default_dtype():
    """f64 when x64 is enabled (bit-parity mode on CPU), else f32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _config_key(config: Configuration) -> Tuple:
    q = config.quantization
    return (config.height, config.width, config.block_size, config.dct_size,
            config.transform, q.name, tuple(sorted(q.params.items())))


def _check_dtype_supported(dtype_name: str) -> None:
    if jnp.dtype(dtype_name) == jnp.float64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "float64 (parity mode) requires jax_enable_x64; enable it "
            "before any jax operation, e.g. "
            'jax.config.update("jax_enable_x64", True) on the CPU backend')


def make_encode(key: Tuple, dtype_name: str) -> Callable:
    """Pure (unjitted) band -> levels function for a static config key."""
    _check_dtype_supported(dtype_name)
    h, w, bs, d, transform, qname, qparams = key
    method = QuantizationMethod(qname, **dict(qparams))
    dtype = jnp.dtype(dtype_name)
    L = d * d
    # Divisible geometry (no edge padding anywhere): the WHOLE f32
    # coefficient path collapses into one dot_general with the combined
    # subsample+transform+zigzag operator, contracting the (r, c) axes of
    # the plane's natural (NV, D, NH, D) view, so XLA can fuse the f32 cast
    # and both relayouts (blockify in, row-major out) into the dot's
    # operand and result reads.  Padded shapes keep the two-step chain
    # (pixel-domain edge replication does not commute with mean-pooling at
    # the seam).
    divisible = (h % bs == 0 and w % bs == 0
                 and (h // bs) % d == 0 and (w // bs) % d == 0)
    combined = (transform in ("DCT", "DFT") and divisible
                and dtype != jnp.float64)
    # DCT factors separably ((A@S) kron (A@S)), so the combined map runs as
    # two chained single-axis contractions that never materialize the
    # blockify transpose.  DFT's real-part operator is a difference of two
    # kron products, so it keeps the joint dot.
    separable = combined and transform == "DCT"
    # Non-divisible DCT f32: subsample + DCT-pad in XLA first (the padded
    # subsampled plane is ALWAYS d-divisible), then the SAME separable
    # two-stage contraction with the bs = 1 factor instead of a blockify
    # transpose plus a vmapped per-block matmul.
    sep_pad = (transform == "DCT" and not combined
               and dtype != jnp.float64)
    if separable or sep_pad:
        fac = T.separable_encode_factor(d, bs if separable else 1)
        zzp = np.asarray(T.zigzag_permutation(d), np.int32)
    elif combined:
        op2 = T.combined_encode_operator(d, bs, transform)   # (L, D*D)

    def sep2(x, width):
        """Separable DCT+zigzag of an f32 plane whose last two dims are
        multiples of ``fac.shape[1]``/``d``; batch-polymorphic — the
        leading reshape merges any band batch into the row-group axis, so
        a batch runs as one unbatched contraction instead of a vmapped
        (batched) dot_general."""
        D2 = fac.shape[1]
        ft = jnp.asarray(fac.T, jnp.float32)                 # (D2, d)
        xr = x.reshape(-1, D2, width)
        # stage 1: contract the D2 pixel-row axis; the full image width
        # stays minor/contiguous so the dot reads it without a copy
        t1 = jax.lax.dot_general(
            xr, ft, (((1,), (0,)), ((), ())),
            precision=T._mm_precision())                     # (B*NV, W, r)
        t1 = t1.reshape(-1, width // D2, D2, d)
        t2 = jax.lax.dot_general(
            t1, ft, (((2,), (0,)), ((), ())),
            precision=T._mm_precision())                   # (B*NV, NH, r, c)
        return jnp.take(t2.reshape(-1, L), jnp.asarray(zzp), axis=1)

    def f(band):
        if separable:
            coeffs = sep2(band.astype(jnp.float32), w)
            levels = Q.quantize(coeffs, method, d)
            return levels.astype(jnp.int32)
        if sep_pad:
            # subsample_fast pads to a block_size multiple itself with the
            # same edge replication (reference padding.py:9-10), keeping
            # the pinned f32 add order of the divisible path
            sub = B.subsample_fast_hw(band, bs)
            sub = B.pad_edge_hw(sub, d)
            coeffs = sep2(sub, sub.shape[-1])
            levels = Q.quantize(coeffs, method, d)
            return levels.astype(jnp.int32)
        if combined:
            D = d * bs
            op4 = jnp.asarray(op2.T.reshape(D, D, L), jnp.float32)
            x4 = band.astype(jnp.float32).reshape(h // D, D, w // D, D)
            coeffs = jax.lax.dot_general(
                x4, op4, (((1, 3), (0, 1)), ((), ())),
                precision=T._mm_precision())             # (NV, NH, L)
            levels = Q.quantize(coeffs.reshape(-1, L), method, d)
            return levels.astype(jnp.int32)
        a = band
        if bs > 1:                      # Padding step skips when block_size==1
            a = B.pad_edge(a, bs)       # (reference pipeline/padding.py:9-10)
        parity = dtype == jnp.float64
        if parity:
            sub = B.subsample(a.astype(dtype), bs)
        else:
            # f32 fast path for padded shapes: fixed-order adds
            # (ops/blocks.py:subsample_fast), then the two-step transform.
            sub = B.subsample_fast(a, bs)
        sub = B.pad_edge(sub, d)
        blk = B.blockify(sub, d)        # (NV, NH, d, d)
        nv, nh = blk.shape[:2]
        if transform not in ("DCT", "DFT"):
            raise ValueError(f"unknown transform {transform!r}")
        if parity:
            # x64 oracle mode: reference-evaluation-order host transform
            # for deterministic ULP parity (see ops/transform.py).
            if transform == "DCT":
                coeffs = T.exact_dct2_zigzag(blk, d).reshape(nv * nh, L)
            else:
                coeffs = T.exact_dft2_real_zigzag(
                    blk.reshape(nv * nh, d, d), d)
        elif transform == "DCT":
            coeffs = T.dct2_zigzag(blk.reshape(nv * nh, L), d)
        else:
            coeffs = T.dft2_real_zigzag(blk.reshape(nv * nh, d, d), d)
        levels = Q.quantize(coeffs, method, d)
        return levels.astype(jnp.int32)

    f.separable = separable or sep_pad
    return f


def make_encode_batch(key: Tuple, dtype_name: str) -> Callable:
    """(B, H, W) band batch -> (B, num_blocks, L) levels.

    The separable fast path is batch-polymorphic (its leading reshape
    absorbs the band axis), so batches go through UNBATCHED dot_generals
    rather than a vmapped dot_general with a batched contraction layout.
    Non-separable configs fall back to vmap.
    """
    enc = make_encode(key, dtype_name)
    if not getattr(enc, "separable", False):
        return jax.vmap(enc)

    def g(bands):
        lv = enc(bands)
        return lv.reshape(bands.shape[0], -1, lv.shape[-1])

    return g


@functools.lru_cache(maxsize=None)
def _encode_fn(key: Tuple, dtype_name: str) -> Callable:
    return jax.jit(make_encode(key, dtype_name))


def make_decode(key: Tuple, dtype_name: str) -> Callable:
    """Pure (unjitted) levels -> band function for a static config key."""
    _check_dtype_supported(dtype_name)
    h, w, bs, d, transform, qname, qparams = key
    method = QuantizationMethod(qname, **dict(qparams))
    dtype = jnp.dtype(dtype_name)
    cfg = Configuration(width=w, height=h, block_size=bs, dct_size=d,
                        transform=transform,
                        quantization=QuantizationMethod(qname, **dict(qparams)))
    nv, nh = cfg.blocks_high, cfg.blocks_wide
    # Divisible geometry: the decode dual of the combined encode operator —
    # dezigzag + IDCT + nearest-neighbor inflate as ONE matmul (replica
    # rows are identical, so round-after-matmul == round-then-inflate
    # bitwise; see transform.py:combined_decode_operator).  Kills the
    # separate inflate/crop passes over the plane.
    divisible = (h % bs == 0 and w % bs == 0
                 and (h // bs) % d == 0 and (w // bs) % d == 0)
    combined = (transform in ("DCT", "DFT") and divisible
                and dtype != jnp.float64)
    D = d * bs
    if combined:
        dec2 = T.combined_decode_operator(d, bs, transform)   # (D*D, L)

    def f(levels):
        if combined:
            itype = jnp.int64 if jax.config.jax_enable_x64 else jnp.int32
            deq = Q.dequantize(levels.astype(itype), method, d)
            pix = jnp.matmul(deq.astype(dtype), jnp.asarray(dec2.T, dtype),
                             precision=T._mm_precision())
            pix = jnp.clip(jnp.round(pix), 0, 255).astype(jnp.int32)
            return B.deblockify(pix.reshape(nv, nh, D, D))
        # int64 only in x64/parity mode; int32 is ample otherwise (|level|
        # <= 16383 and the largest qtable restore product is < 2**21).
        itype = jnp.int64 if jax.config.jax_enable_x64 else jnp.int32
        deq = Q.dequantize(levels.astype(itype), method, d)
        parity = dtype == jnp.float64
        if transform == "DCT":
            if parity:
                pix = T.exact_izigzag_idct2(deq.astype(dtype), d)
            else:
                pix = T.izigzag_idct2(deq.astype(dtype), d)
            blk = pix.reshape(nv, nh, d, d)
        elif transform == "DFT":
            if parity:
                blk = T.exact_izigzag_idft2_real(deq.astype(dtype), d)
            else:
                blk = T.izigzag_idft2_real(deq.astype(dtype), d)
            blk = blk.reshape(nv, nh, d, d)
        else:
            raise ValueError(f"unknown transform {transform!r}")
        plane = B.deblockify(blk)
        # BasisChange.invert rounds to int FIRST (basis_change.py:43), then
        # Normalization.invert clamps to [0, 255] (normalization.py:10-14).
        plane = jnp.clip(jnp.round(plane), 0, 255).astype(jnp.int32)
        plane = B.crop(plane, cfg.subsampled_height, cfg.subsampled_width)
        plane = B.inflate(plane, bs)
        return B.crop(plane, h, w)

    return f


@functools.lru_cache(maxsize=None)
def _decode_fn(key: Tuple, dtype_name: str) -> Callable:
    return jax.jit(make_decode(key, dtype_name))


def config_key(config: Configuration) -> Tuple:
    """Public alias of the static config signature used for fn caching."""
    return _config_key(config)


def check_band_shape(band, config: Configuration) -> None:
    """The encoder derives geometry from the array while the header stores
    config dims; a mismatch would silently write a corrupt container."""
    from ..config import BadArrayShapeError
    if tuple(band.shape) != (config.height, config.width):
        raise BadArrayShapeError(
            f"band shape {tuple(band.shape)} != configured "
            f"(height, width) = {(config.height, config.width)}")


def encode_band_levels(band, config: Configuration, dtype=None) -> jax.Array:
    """(H, W) integer band -> (num_blocks, d*d) int32 zigzag levels."""
    check_band_shape(np.asarray(band), config)
    dt = np.dtype(dtype if dtype is not None else default_dtype())
    return _encode_fn(_config_key(config), dt.name)(jnp.asarray(band))


def decode_band_levels(levels, config: Configuration, dtype=None) -> jax.Array:
    """(num_blocks, d*d) integer levels -> (H, W) int32 reconstructed band."""
    dt = np.dtype(dtype if dtype is not None else default_dtype())
    arr = jnp.asarray(levels)
    expected = (config.num_blocks, config.dct_size ** 2)
    if arr.shape != expected:
        raise ValueError(f"levels shape {arr.shape} != expected {expected}")
    return _decode_fn(_config_key(config), dt.name)(arr)
