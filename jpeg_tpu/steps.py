"""Invertible ordered-step pipeline — the reference's key architecture,
as jitted array code.

The reference structures the codec as a totally-ordered list of invertible
steps, auto-registered by a metaclass and sorted by a mandatory
``step_index`` class attribute (reference: pipeline/base.py:4-31; a subclass
without the attribute raises ``MissingStepIndexError``, base.py:9-17).
``compress_band`` runs ``execute`` in ascending order and ``decompress_band``
runs ``invert`` in descending order (reference: pipeline/__init__.py:71-88).

This module keeps that architecture — same step classes, same indices, same
intermediate array shapes/dtypes — but each device step's body is a batched
jnp expression (one op over all blocks) instead of per-block Python loops.
Steps 0-6 produce jax Arrays; steps 7-8 (inherently variable-length entropy
views) produce host lists/bytes, exactly like the reference's list-of-tuples
and bitarray bytes.

The production fused path (ops/band.py) is the performance surface; this
step view exists for extensibility (subclass AlgorithmStep with a new
step_index to splice in a custom step), for debugging intermediates, and for
step-level parity testing.  In x64 parity mode the BasisChange step uses the
reference-evaluation-order transforms so every intermediate matches the
reference bitwise.
"""
from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from .config import Configuration, padded_size
from .entropy import tuples as TU
from .ops import blocks as B
from .ops import quantize as Q
from .ops import transform as T


class MissingStepIndexError(Exception):
    """Subclass forgot the ``step_index`` attribute (base.py:38)."""


class IndexOutOfOrderError(Exception):
    """Reserved, mirroring the reference's exception surface (base.py:34)."""


#: Ordered registry of all step classes (reference: pipeline/base.py:4).
step_classes: List[type] = []


class AlgorithmStep:
    """Base class; subclasses auto-register sorted by ``step_index``."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "step_index" not in cls.__dict__:
            raise MissingStepIndexError(
                f'Class {cls.__name__} has not defined "step_index" '
                f"class attribute")
        step_classes.append(cls)
        step_classes.sort(key=lambda c: c.step_index)

    def __init__(self, config: Configuration):
        self._config = config

    def execute(self, array):
        raise NotImplementedError

    def invert(self, array):
        raise NotImplementedError

    # Shared helpers (reference: base.py:52-72).
    def calculate_padding(self, factor: int):
        w, h = self._config.width, self._config.height
        return padded_size(h, factor) - h, padded_size(w, factor) - w

    def blocks(self, a, block_size: int):
        """Yield (block, y, x) over the block grid (base.py:60-68)."""
        tiles = B.blockify(jnp.asarray(a), block_size)
        for y in range(tiles.shape[0]):
            for x in range(tiles.shape[1]):
                yield tiles[y, x], y, x

    def apply_blockwise(self, a, transformation, block_size: int, res=None):
        """Apply ``transformation`` to every block (base.py:70-72).

        Unlike the reference's nested write loop, the function is vmapped
        over the whole block batch in one dispatch; ``res`` (if given) is
        filled for signature compatibility and also returned.
        """
        tiles = B.blockify(jnp.asarray(a), block_size)
        out = jax.vmap(jax.vmap(transformation))(tiles)
        plane = B.deblockify(out)
        if res is not None:
            res[...] = np.asarray(plane)
        return plane

    def _parity(self) -> bool:
        return jax.config.jax_enable_x64

    def _float_dtype(self):
        return jnp.float64 if self._parity() else jnp.float32


class Padding(AlgorithmStep):
    """Edge-replicate to a multiple of block_size (padding.py:5-16)."""

    step_index = 0

    def execute(self, array):
        if self._config.block_size == 1:        # no-op (padding.py:9-10)
            return jnp.asarray(array)
        return B.pad_edge(jnp.asarray(array), self._config.block_size)

    def invert(self, array):
        return array[:self._config.height, :self._config.width]


class SubSampling(AlgorithmStep):
    """Mean-pool block_size tiles; inverse is nearest-neighbour inflate
    (subsampling.py:6-14).  Applied to every band including luma."""

    step_index = 1

    def execute(self, array):
        return B.subsample(jnp.asarray(array, self._float_dtype()),
                           self._config.block_size)

    def invert(self, array):
        return B.inflate(array, self._config.block_size)


class DCTPadding(AlgorithmStep):
    """Edge-replicate the subsampled plane to a multiple of dct_size
    (dct_padding.py:5-21)."""

    step_index = 2

    def execute(self, array):
        return B.pad_edge(jnp.asarray(array), self._config.dct_size)

    def invert(self, array):
        cfg = self._config
        return array[:cfg.subsampled_height, :cfg.subsampled_width]


class Normalization(AlgorithmStep):
    """Forward identity; inverse clamps to [0, 255]
    (normalization.py:4-14, replacing the per-pixel Python loop)."""

    step_index = 3

    def execute(self, array):
        return array

    def invert(self, array):
        return jnp.clip(array, 0, 255)


class BasisChange(AlgorithmStep):
    """Blockwise 2-D DCT (float) or DFT (complex); inverse rounds to int
    (basis_change.py:11-43)."""

    step_index = 4

    def execute(self, array):
        d = self._config.dct_size
        blk = B.blockify(jnp.asarray(array), d)     # (NV, NH, d, d)
        if self._config.transform == "DCT":
            if self._parity():
                out = T.exact_dct2_blocks(blk, d)
            else:
                nv, nh = blk.shape[:2]
                m = jnp.asarray(T.kron_operator(d), blk.dtype)
                out = jnp.matmul(blk.reshape(nv, nh, d * d), m.T,
                                 precision=jax.lax.Precision.HIGHEST)
                out = out.reshape(nv, nh, d, d)
        elif self._config.transform == "DFT":
            if self._parity():
                out = T.exact_fft2_blocks(blk.astype(jnp.complex128), d)
            else:
                out = jnp.fft.fft2(blk)
        else:
            raise ValueError(self._config.transform)
        return B.deblockify(out)

    def invert(self, array):
        d = self._config.dct_size
        blk = B.blockify(jnp.asarray(array), d)
        if self._config.transform == "DCT":
            if self._parity():
                out = T.exact_idct2_blocks(blk.astype(jnp.float64), d)
            else:
                nv, nh = blk.shape[:2]
                w = jnp.asarray(T.kron_inverse_operator(d),
                                self._float_dtype())
                out = jnp.matmul(blk.reshape(nv, nh, d * d).astype(w.dtype),
                                 w.T, precision=jax.lax.Precision.HIGHEST)
                out = out.reshape(nv, nh, d, d)
        elif self._config.transform == "DFT":
            if self._parity():
                out = T.exact_ifft2_blocks(blk.astype(jnp.complex128), d)
            else:
                out = jnp.fft.ifft2(blk)
            out = jnp.real(out)
        else:
            raise ValueError(self._config.transform)
        plane = B.deblockify(out)
        # Round then int cast (basis_change.py:43); clamping is the next
        # step's invert.
        itype = jnp.int64 if self._parity() else jnp.int32
        return jnp.round(plane).astype(itype)


def _round_preserving_complex(a):
    if jnp.iscomplexobj(a):
        return jnp.round(a.real) + 1j * jnp.round(a.imag)
    return jnp.round(a)


class Quantization(AlgorithmStep):
    """Blockwise quantize/restore with dtype preserved
    (quantization.py:5-30, quantizers.py)."""

    step_index = 5

    def _tiled(self, table_2d, shape):
        d = self._config.dct_size
        return jnp.tile(jnp.asarray(table_2d),
                        (shape[0] // d, shape[1] // d))

    def execute(self, array):
        m = self._config.quantization
        d = self._config.dct_size
        if m.name == "none":
            return _round_preserving_complex(array)
        if m.name == "discard":
            rows = np.arange(d)[:, None] < m.keep
            cols = np.arange(d)[None, :] < m.keep
            mask = self._tiled((rows & cols).astype(np.float64), array.shape)
            return _round_preserving_complex(array) * mask.astype(array.dtype)
        if m.name == "divide":
            div = jnp.asarray(float(m.divisor))
            if self._parity():
                div = jax.lax.optimization_barrier(
                    div.astype(jnp.float64))     # defeat reciprocal rewrite
            return _round_preserving_complex(array / div.astype(
                jnp.complex128 if jnp.iscomplexobj(array) else div.dtype))
        if m.name == "qtable":
            inv_q = self._tiled(1.0 / Q.JPEG_QTABLE, array.shape)
            return _round_preserving_complex(array * inv_q.astype(array.dtype))
        raise ValueError(m.name)

    def invert(self, array):
        m = self._config.quantization
        if m.name in ("none", "discard"):
            return array
        if m.name == "divide":
            d = m.divisor
            x64 = jax.config.jax_enable_x64
            if float(d) == int(d) and (x64 or int(d) <= (2 ** 31 - 1) // 16383):
                return array * int(d)
            ftype = jnp.float64 if x64 else jnp.float32
            prod = jnp.trunc(array.astype(ftype) * float(d))
            return prod.astype(array.dtype) if x64 else prod
        if m.name == "qtable":
            q = self._tiled(Q.JPEG_QTABLE.astype(np.int64), array.shape)
            return array * q.astype(array.dtype)
        raise ValueError(m.name)


class ZigzagOrder(AlgorithmStep):
    """(H, W) coefficient plane -> (NV, NH, d*d) zigzag tensor; one gather
    instead of per-block index loops (zigzag_order.py:82-119)."""

    step_index = 6

    def execute(self, array):
        d = self._config.dct_size
        blk = B.blockify(jnp.asarray(array), d)
        nv, nh = blk.shape[:2]
        flat = blk.reshape(nv, nh, d * d)
        return jnp.take(flat, jnp.asarray(T.zigzag_permutation(d)), axis=-1)

    def invert(self, array):
        d = self._config.dct_size
        nv, nh = array.shape[:2]
        flat = jnp.take(jnp.asarray(array),
                        jnp.asarray(T.inverse_zigzag_permutation(d)), axis=-1)
        return B.deblockify(flat.reshape(nv, nh, d, d))


class RunLengthEncoding(AlgorithmStep):
    """Zigzag tensor -> flat list of (run, size, amplitude) tuples with EOB
    markers (run_length_encoding.py:44-88); host-side view."""

    step_index = 7

    def execute(self, array):
        arr = np.asarray(array)
        nv, nh, L = arr.shape
        return TU.encode_levels_to_tuples(arr.reshape(nv * nh, L))

    def invert(self, tuples_list):
        cfg = self._config
        nv, nh = cfg.blocks_high, cfg.blocks_wide
        levels = TU.decode_tuples_to_levels(tuples_list, nv * nh,
                                            cfg.dct_size ** 2)
        return jnp.asarray(levels.reshape(nv, nh, cfg.dct_size ** 2))


class RleBytestream(AlgorithmStep):
    """Tuple list <-> byte-aligned bitstream (rle_byte_stream.py:45-88)."""

    step_index = 8

    def execute(self, tuples_list):
        return TU.tuples_to_bytes(tuples_list)

    def invert(self, bytestream):
        return TU.bytes_to_tuples(bytes(bytestream))


def compress_band_steps(a, config: Configuration) -> bytes:
    """Run every step's ``execute`` in ascending index order
    (reference: pipeline/__init__.py:71-76)."""
    for cls in step_classes:
        a = cls(config).execute(a)
    return a


def decompress_band_steps(bytestream: bytes, config: Configuration):
    """Run every step's ``invert`` in descending index order
    (reference: pipeline/__init__.py:79-88)."""
    a = bytestream
    for cls in reversed(step_classes):
        a = cls(config).invert(a)
    return np.asarray(a)
