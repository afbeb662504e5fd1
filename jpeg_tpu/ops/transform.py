"""Block transforms: unnormalized DCT-II (and DFT), fused with zigzag.

Design note
-----------
The reference computes the 2-D DCT per block as two passes of 1-D matvecs in
Python loops (reference: transforms.py:46-75) and then gathers the zigzag
order per block in another Python loop (reference: pipeline/zigzag_order.py).
Here both collapse into a *single* large matmul: the 2-D transform is
separable, so for a block ``a``:

    vec(A @ a @ A.T) = (A kron A) @ vec(a)

and the zigzag reorder is just a row permutation of ``A kron A``.  So the
whole coefficient path for a batch of N blocks is one
``(N, d*d) @ (d*d, d*d)`` matmul (contraction dim d*d is 64+ instead of
d=8) and bandwidth-optimal (one read, one write).  The
elementwise quantization afterwards is fused into the matmul epilogue by XLA.

The DCT matrix is the reference's *unnormalized* DCT-II,
``A[k, n] = cos(pi/N * (n + 0.5) * k)`` (reference: transforms.py:4-11) —
coefficients are ~N times larger than the orthonormal JPEG DCT, which matters
for quantizer semantics.  The inverse is ``B = A_norm.T @ D^-1`` with
row-normalized ``A_norm`` and ``D = diag(row norms)``
(reference: transforms.py:40-44), i.e. ``B = A.T @ D^-2`` — an exact inverse
up to float rounding.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Unnormalized DCT-II matrix (float64). Reference: transforms.py:4-11."""
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(np.pi / n * (m + 0.5) * k)


@functools.lru_cache(maxsize=None)
def idct_matrix(n: int) -> np.ndarray:
    """Inverse of :func:`dct_matrix`: ``A_norm.T @ D^-1`` (transforms.py:40-44)."""
    a = dct_matrix(n)
    norms = np.linalg.norm(a, axis=1)
    a_norm = a / norms[:, None]
    return a_norm.T @ np.diag(1.0 / norms)


@functools.lru_cache(maxsize=None)
def zigzag_permutation(n: int) -> np.ndarray:
    """Flat (row-major) block indices in zigzag scan order, shape (n*n,).

    Diagonal walk: up-diagonals from the top-left rows, then from the
    bottom-right columns, with every odd diagonal reversed
    (reference: pipeline/zigzag_order.py:27-80).
    """
    diags = []
    for r in range(n):
        diags.append([(r - t, t) for t in range(r + 1)])
    for c in range(1, n):
        diags.append([(n - 1 - t, c + t) for t in range(n - c)])
    order = []
    for k, d in enumerate(diags):
        if k % 2 == 1:
            d = d[::-1]
        order.extend(i * n + j for i, j in d)
    return np.asarray(order, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def inverse_zigzag_permutation(n: int) -> np.ndarray:
    zz = zigzag_permutation(n)
    inv = np.empty_like(zz)
    inv[zz] = np.arange(n * n, dtype=np.int32)
    return inv


@functools.lru_cache(maxsize=None)
def encode_operator(n: int) -> np.ndarray:
    """(d*d, d*d) matrix ``M`` with ``coeffs_zz = M @ vec(block)``.

    Row ``p`` is row ``zz[p]`` of ``A kron A``: DCT + zigzag in one matmul.
    """
    a = dct_matrix(n)
    m2 = np.kron(a, a)
    return m2[zigzag_permutation(n), :]


@functools.lru_cache(maxsize=None)
def decode_operator(n: int) -> np.ndarray:
    """(d*d, d*d) matrix ``W`` with ``vec(block) = W @ coeffs_zz``.

    Column ``p`` is column ``zz[p]`` of ``B kron B``: dezigzag + IDCT fused.
    """
    b = idct_matrix(n)
    w2 = np.kron(b, b)
    return w2[:, zigzag_permutation(n)]


@functools.lru_cache(maxsize=None)
def combined_encode_operator(d: int, bs: int,
                             transform: str = "DCT") -> np.ndarray:
    """(d*d, (d*bs)^2) operator fusing mean-pool subsample with the
    transform+zigzag matmul: ``coeffs_zz = OP2 @ vec(pixel_block)`` where
    the pixel block is the (d*bs) x (d*bs) region that subsamples to one
    d x d transform block.

    The entire f32 coefficient path becomes ONE matmul: no separate
    subsample pass, no intermediate plane.  Built in float64 and cast to
    f32 at use, like the plain operators.  Only valid
    when the band needs no edge padding (callers gate on divisibility; the
    padded path keeps the two-step chain because pixel-domain edge
    replication does not commute with mean-pooling at the seam).
    """
    D = d * bs
    sub = np.zeros((d * d, D * D), dtype=np.float64)
    w = 1.0 / (bs * bs)
    for p in range(d):
        for q in range(d):
            for i in range(bs):
                for j in range(bs):
                    sub[p * d + q, (p * bs + i) * D + (q * bs + j)] = w
    enc = (encode_operator(d) if transform == "DCT"
           else dft_encode_operator(d))
    return enc @ sub


@functools.lru_cache(maxsize=None)
def separable_encode_factor(d: int, bs: int) -> np.ndarray:
    """(d, d*bs) separable factor ``F`` of the DCT combined encode
    operator: ``combined_encode_operator(d, bs, "DCT") == (F kron F)[zz]``
    because the 2-D mean-pool factors as ``S kron S`` and the 2-D DCT as
    ``A kron A``, so ``(A@S) kron (A@S)`` is the whole pixel->coefficient
    map; zigzag stays a static permutation of the (r, c) row-major result.

    Two chained single-axis contractions with this factor avoid the
    blockify transpose the jointly-contracted operator forces XLA to
    materialize: stage 1 contracts pixel rows with the full image width
    contiguous/minor.  f32 summation order differs from the
    joint dot, so this is a fast-path-only form (parity mode keeps the
    reference-order host transform).
    """
    D = d * bs
    sub = np.zeros((d, D), dtype=np.float64)
    for p in range(d):
        sub[p, p * bs:(p + 1) * bs] = 1.0 / bs
    return dct_matrix(d) @ sub


@functools.lru_cache(maxsize=None)
def combined_decode_operator(d: int, bs: int,
                             transform: str = "DCT") -> np.ndarray:
    """((d*bs)^2, d*d) operator fusing dezigzag+IDCT with the
    nearest-neighbor inflate: ``vec(pixel_block) = OP2 @ coeffs_zz`` where
    the pixel block is the (d*bs) x (d*bs) region one d x d transform block
    inflates to (reference pipeline/subsampling.py invert: each subsampled
    pixel repeats bs x bs).

    Replica rows are IDENTICAL rows of the plain decode operator, so each
    replica's f32 dot product is bitwise equal — rounding after the matmul
    equals the reference's round-then-inflate order exactly.  Only valid on
    divisible geometry (no crops anywhere); callers gate like the encode
    dual (combined_encode_operator).
    """
    D = d * bs
    rep = np.zeros((D * D, d * d), dtype=np.float64)
    for p in range(d):
        for q in range(d):
            for i in range(bs):
                for j in range(bs):
                    rep[(p * bs + i) * D + (q * bs + j), p * d + q] = 1.0
    dec = (decode_operator(d) if transform == "DCT"
           else dft_decode_operator(d))
    return rep @ dec


def _mm_precision():
    # Full-f32 products: without HIGHEST a GPU may run f32 dots in TF32
    # (10-bit mantissa), far too coarse for pixel blocks of magnitude up to
    # 255*d*d and bit-faithful coefficients.
    return jax.lax.Precision.HIGHEST


def dct2_zigzag(blocks_vec, n: int):
    """Batched fused 2-D DCT + zigzag.

    Args:
      blocks_vec: (..., d*d) row-major flattened pixel blocks (float).
      n: dct_size.
    Returns:
      (..., d*d) zigzag-ordered unnormalized DCT-II coefficients.
    """
    m = jnp.asarray(encode_operator(n), dtype=blocks_vec.dtype)
    return jnp.matmul(blocks_vec, m.T, precision=_mm_precision())


def izigzag_idct2(coeffs_zz, n: int):
    """Batched fused dezigzag + inverse 2-D DCT.

    Args:
      coeffs_zz: (..., d*d) zigzag-ordered (dequantized) coefficients.
    Returns:
      (..., d*d) row-major flattened pixel blocks (float, unrounded).
    """
    w = jnp.asarray(decode_operator(n), dtype=coeffs_zz.dtype)
    return jnp.matmul(coeffs_zz, w.T, precision=_mm_precision())


# ---------------------------------------------------------------------------
# DFT mode (reference: pipeline/basis_change.py:20-25, 38-41).
#
# The reference keeps complex coefficients through quantization, but the RLE
# step casts them to int, discarding the imaginary part
# (reference: run_length_encoding.py:16-17 + numpy complex->int cast).  Since
# every quantizer acts elementwise-separately on real/imag, the real part of
# the quantized coefficient equals the quantization of the real part — so the
# encode path only ever needs real(fft2(block)).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def dct_matrix_normalized(n: int) -> np.ndarray:
    """Row-normalized DCT matrix (reference transforms.py:14-20).

    Per-row scalar norms, not an axis reduction: the two differ by 1 ULP
    (BLAS dot vs add.reduce), and this matrix is part of the bit-parity
    surface."""
    a = dct_matrix(n).copy()
    for k in range(n):
        a[k] /= np.linalg.norm(a[k])
    return a


@functools.lru_cache(maxsize=None)
def normalization_matrix(n: int) -> np.ndarray:
    """diag(1/row_norm) (reference transforms.py:23-26)."""
    return np.diag(1.0 / np.linalg.norm(dct_matrix(n), axis=1))


class DCT:
    """Drop-in class surface for the reference's DCT object
    (transforms.py:29-75): 1-D/2-D transforms with the same unnormalized
    scale, vectorized instead of per-row Python loops."""

    def __init__(self, size: int):
        self._size = size

    def transform_1d(self, x):
        return np.asarray(dct_matrix(self._size) @ np.asarray(x))

    def transform_1d_inverse(self, x):
        return np.asarray(idct_matrix(self._size) @ np.asarray(x))

    def transform_2d(self, a):
        m = dct_matrix(self._size)
        return np.asarray(m @ np.asarray(a) @ m.T)

    def transform_2d_inverse(self, a):
        b = idct_matrix(self._size)
        return np.asarray(b @ np.asarray(a) @ b.T)


class Zigzag:
    """Drop-in zigzag gather/scatter for one block
    (reference pipeline/zigzag_order.py:12-79)."""

    def __init__(self, size: int):
        self._size = size

    def zigzag_order(self, block):
        from ..config import BadArrayShapeError
        block = np.asarray(block)
        if block.shape != (self._size, self._size):
            raise BadArrayShapeError(block.shape)
        return block.reshape(-1)[zigzag_permutation(self._size)]

    def restore(self, zigzag_vec):
        from ..config import BadArrayShapeError
        v = np.asarray(zigzag_vec)
        if v.shape != (self._size * self._size,):
            raise BadArrayShapeError(v.shape)
        return v[inverse_zigzag_permutation(self._size)]


# ---------------------------------------------------------------------------
# Parity-exact transforms (x64 oracle mode only).
#
# Rounded raw coefficients are not ULP-robust: for d=8 the k=4 DCT row is
# +-cos(pi/4), so products make coefficients that are *exact* half-integers
# (0.5 * integer); which side of the .5 boundary the computed f64 value lands
# on depends on the accumulation order of the implementation.  A matmul
# (any matmul) therefore cannot reproduce the reference's np.round results
# bitwise.  In parity mode we instead evaluate the transform on the host with
# the reference's exact expression tree — per-row 1-D matvecs, two passes
# (reference: transforms.py:36-75) — via jax.pure_callback.  The f32
# fast path never uses this.
# ---------------------------------------------------------------------------

def _ref_matrices(n: int):
    a = dct_matrix(n)
    # Row-normalized matrix: per-row scalar norms (transforms.py:14-20).
    a_norm = a.copy()
    for k in range(n):
        a_norm[k] = a_norm[k] / np.linalg.norm(a_norm[k])
    # Diagonal inverse-norm matrix built from the axis-norm (transforms.py:23-26).
    dinv = np.diag(1.0 / np.linalg.norm(a, axis=1))
    return a, a_norm.T, dinv


def _host_dct2(blocks: np.ndarray, n: int) -> np.ndarray:
    """(..., n, n) -> (..., n, n) forward DCT, reference evaluation order."""
    a, _, _ = _ref_matrices(n)
    flat = np.ascontiguousarray(blocks, dtype=np.float64).reshape(-1, n, n)
    out = np.empty_like(flat)
    for b in range(flat.shape[0]):
        m = np.zeros((n, n))
        for i in range(n):
            m[i] = a.dot(flat[b][i])          # row pass (transforms.py:52-56)
        mt = m.T
        r = np.zeros((n, n))
        for i in range(n):
            r[i] = a.dot(mt[i])               # column pass (:58-59)
        out[b] = r.T
    return out.reshape(blocks.shape)


def _host_idct2(coeffs: np.ndarray, n: int) -> np.ndarray:
    """Inverse DCT, reference evaluation order (transforms.py:40-44, 61-68)."""
    _, w, dinv = _ref_matrices(n)
    flat = np.ascontiguousarray(coeffs, dtype=np.float64).reshape(-1, n, n)
    out = np.empty_like(flat)
    for b in range(flat.shape[0]):
        at = flat[b].T
        m = np.zeros((n, n))
        for i in range(n):
            m[i] = w.dot(dinv.dot(at[i]))     # column pass first
        m = m.T
        r = np.zeros((n, n))
        for i in range(n):
            r[i] = w.dot(dinv.dot(m[i]))      # then row pass
        out[b] = r
    return out.reshape(coeffs.shape)


def _host_fft2_real(blocks: np.ndarray, n: int) -> np.ndarray:
    flat = np.ascontiguousarray(blocks, dtype=np.float64).reshape(-1, n, n)
    out = np.empty_like(flat)
    for b in range(flat.shape[0]):            # per block like apply_blockwise
        out[b] = np.fft.fft2(flat[b]).real
    return out.reshape(blocks.shape)


def _host_ifft2_real(coeffs: np.ndarray, n: int) -> np.ndarray:
    flat = np.ascontiguousarray(coeffs, dtype=np.float64).reshape(-1, n, n)
    out = np.empty_like(flat)
    for b in range(flat.shape[0]):
        out[b] = np.fft.ifft2(flat[b]).real
    return out.reshape(coeffs.shape)


def _callback(host_fn, blocks, n: int):
    fn = functools.partial(host_fn, n=n)
    return jax.pure_callback(
        fn, jax.ShapeDtypeStruct(blocks.shape, jnp.float64),
        blocks.astype(jnp.float64), vmap_method="expand_dims")


def _host_fft2_complex(blocks: np.ndarray, n: int) -> np.ndarray:
    flat = np.ascontiguousarray(blocks).reshape(-1, n, n)
    out = np.empty(flat.shape, dtype=np.complex128)
    for b in range(flat.shape[0]):
        out[b] = np.fft.fft2(flat[b])
    return out.reshape(blocks.shape)


def _host_ifft2_complex(blocks: np.ndarray, n: int) -> np.ndarray:
    flat = np.ascontiguousarray(blocks).reshape(-1, n, n)
    out = np.empty(flat.shape, dtype=np.complex128)
    for b in range(flat.shape[0]):
        out[b] = np.fft.ifft2(flat[b])
    return out.reshape(blocks.shape)


def exact_fft2_blocks(blocks, n: int):
    """Parity-mode per-block np.fft.fft2, complex128 (basis_change.py:20-25)."""
    return jax.pure_callback(
        functools.partial(_host_fft2_complex, n=n),
        jax.ShapeDtypeStruct(blocks.shape, jnp.complex128),
        blocks, vmap_method="expand_dims")


def exact_ifft2_blocks(blocks, n: int):
    """Parity-mode per-block np.fft.ifft2, complex128 (basis_change.py:38-41)."""
    return jax.pure_callback(
        functools.partial(_host_ifft2_complex, n=n),
        jax.ShapeDtypeStruct(blocks.shape, jnp.complex128),
        blocks, vmap_method="expand_dims")


def exact_dct2_blocks(blocks, n: int):
    """Parity-mode forward DCT on (..., d, d) blocks (no zigzag)."""
    return _callback(_host_dct2, blocks, n)


def exact_idct2_blocks(blocks, n: int):
    """Parity-mode inverse DCT on (..., d, d) blocks (no zigzag)."""
    return _callback(_host_idct2, blocks, n)


@functools.lru_cache(maxsize=None)
def kron_operator(n: int) -> np.ndarray:
    """(d*d, d*d) forward 2-D DCT operator in row-major order (no zigzag)."""
    a = dct_matrix(n)
    return np.kron(a, a)


@functools.lru_cache(maxsize=None)
def kron_inverse_operator(n: int) -> np.ndarray:
    """(d*d, d*d) inverse 2-D DCT operator in row-major order (no zigzag)."""
    b = idct_matrix(n)
    return np.kron(b, b)


def exact_dct2_zigzag(blocks, n: int):
    """Parity-mode fused DCT+zigzag: (..., d, d) blocks -> (..., d*d)."""
    coeffs = _callback(_host_dct2, blocks, n)
    flat = coeffs.reshape(coeffs.shape[:-2] + (n * n,))
    return jnp.take(flat, jnp.asarray(zigzag_permutation(n)), axis=-1)


def exact_izigzag_idct2(coeffs_zz, n: int):
    """Parity-mode dezigzag + inverse DCT: (..., d*d) -> (..., d*d)."""
    flat = jnp.take(coeffs_zz, jnp.asarray(inverse_zigzag_permutation(n)),
                    axis=-1)
    blocks = flat.reshape(flat.shape[:-1] + (n, n))
    out = _callback(_host_idct2, blocks, n)
    return out.reshape(coeffs_zz.shape)


def exact_dft2_real_zigzag(blocks, n: int):
    coeffs = _callback(_host_fft2_real, blocks, n)
    flat = coeffs.reshape(coeffs.shape[:-2] + (n * n,))
    return jnp.take(flat, jnp.asarray(zigzag_permutation(n)), axis=-1)


def exact_izigzag_idft2_real(coeffs_zz, n: int):
    flat = jnp.take(coeffs_zz, jnp.asarray(inverse_zigzag_permutation(n)),
                    axis=-1)
    blocks = flat.reshape(flat.shape[:-1] + (n, n))
    return _callback(_host_ifft2_real, blocks, n)


@functools.lru_cache(maxsize=None)
def dft_encode_operator(n: int) -> np.ndarray:
    """(d*d, d*d) real operator ``M`` with ``re(fft2)_zz = M @ vec(block)``.

    For real pixel blocks, ``fft2(X) = F X F^T`` with the symmetric DFT
    matrix F, so ``vec(fft2(X)) = (F kron F) vec(X)`` and the real part of
    the result is ``Re(F kron F) @ vec(X)`` — the DFT curiosity mode
    (reference basis_change.py:20-25 + the complex->int cast at
    run_length_encoding.py:16-17 that keeps only the real part) becomes the
    SAME fused matmul shape as the DCT path instead of needing an
    on-device FFT.
    """
    j = np.arange(n, dtype=np.float64)
    f = np.exp(-2j * np.pi * np.outer(j, j) / n)
    m2 = np.real(np.kron(f, f))
    return m2[zigzag_permutation(n), :]


@functools.lru_cache(maxsize=None)
def dft_decode_operator(n: int) -> np.ndarray:
    """(d*d, d*d) real operator ``W`` with ``vec(re(ifft2)) = W @ coeffs_zz``
    (G = conj(F)/n per axis; reference basis_change.py:38-41)."""
    j = np.arange(n, dtype=np.float64)
    g = np.exp(2j * np.pi * np.outer(j, j) / n) / n
    w2 = np.real(np.kron(g, g))
    return w2[:, zigzag_permutation(n)]


def dft2_real_zigzag(blocks, n: int):
    """(..., d, d) pixel blocks -> (..., d*d) zigzag-ordered real(DFT2).

    One fused matmul (see :func:`dft_encode_operator`) — the same shape as
    the DCT path."""
    m = jnp.asarray(dft_encode_operator(n), dtype=blocks.dtype)
    vecs = blocks.reshape(blocks.shape[:-2] + (n * n,))
    return jnp.matmul(vecs, m.T, precision=_mm_precision())


def izigzag_idft2_real(coeffs_zz, n: int):
    """(..., d*d) zigzag real coefficients -> (..., d, d) real(IDFT2) blocks."""
    w = jnp.asarray(dft_decode_operator(n), dtype=coeffs_zz.dtype)
    flat = jnp.matmul(coeffs_zz, w.T, precision=_mm_precision())
    return flat.reshape(flat.shape[:-1] + (n, n))
