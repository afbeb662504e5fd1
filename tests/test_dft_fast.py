"""DFT fast path as a fused matmul (no FFT in the fast path).

The reference's DFT mode keeps only the real part of the coefficients once
the RLE step casts complex->int (reference basis_change.py:20-25,
run_length_encoding.py:16-17).  real(fft2) of a real block is linear, so the
fast path uses Re(F kron F) with the zigzag row permutation — the same
matmul shape as the DCT path.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from jpeg_tpu.config import Configuration, QuantizationMethod
from jpeg_tpu.ops import band as band_ops
from jpeg_tpu.ops import quantize as Q
from jpeg_tpu.ops import transform as T

RNG = np.random.default_rng(23)


@pytest.mark.parametrize("d", [2, 3, 4, 8, 16])
def test_dft_operator_matches_fft(d):
    blocks = RNG.uniform(-300, 300, (11, d, d))
    want = np.real(np.fft.fft2(blocks)).reshape(11, d * d)[
        :, T.zigzag_permutation(d)]
    got = T.dft_encode_operator(d) @ blocks.reshape(11, d * d).T
    np.testing.assert_allclose(got.T, want, rtol=1e-9, atol=1e-7)


@pytest.mark.parametrize("d", [2, 3, 8])
def test_dft_inverse_operator_matches_ifft(d):
    coeffs = RNG.uniform(-3000, 3000, (7, d * d))
    deperm = coeffs[:, T.inverse_zigzag_permutation(d)].reshape(7, d, d)
    want = np.real(np.fft.ifft2(deperm))
    got = (T.dft_decode_operator(d) @ coeffs.T).T.reshape(7, d, d)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_dft_roundtrip_is_symmetrization():
    # Keeping only re(fft2) drops the odd part: the round trip equals the
    # circular symmetrization (X + X[-n, -m]) / 2 — the same information
    # loss the reference's complex->int cast produces (its DFT integration
    # test passes only at rtol=1, reference tests/integration_tests.py:41-48).
    for d in (2, 3, 5, 8):
        x = RNG.uniform(0, 255, (d, d))
        y = (T.dft_decode_operator(d)
             @ (T.dft_encode_operator(d) @ x.reshape(-1))).reshape(d, d)
        xr = np.roll(x[::-1, ::-1], (1, 1), axis=(0, 1))   # X[(-n)%d, (-m)%d]
        np.testing.assert_allclose(y, (x + xr) / 2, rtol=1e-9, atol=1e-8)


@pytest.mark.parametrize("method", [
    QuantizationMethod("none"),
    QuantizationMethod("divide", divisor=100),
], ids=lambda m: m.name)
def test_dft_f32_blocks_match_f64(method):
    """The production f32 DFT operator product + quantizer (x64 off) against
    the f64 product, equal except +-1 at provable round ties."""
    from jpeg_tpu.utils.parity import EPS32, assert_tie_equal
    d, L, n = 8, 64, 1029
    blocks = RNG.integers(0, 256, (n, L)).astype(np.float64)
    op = T.dft_encode_operator(d)
    div = float(method.divisor) if method.name == "divide" else 1.0
    q = blocks @ op.T / div
    want = np.round(q).astype(np.int32)
    bound = (L + 16) * EPS32 * (np.abs(blocks) @ np.abs(op.T)) / div
    ties = np.abs(q - np.floor(q) - 0.5) <= bound
    with jax.enable_x64(False):
        coeffs = T.dft2_real_zigzag(
            jnp.asarray(blocks.reshape(n, d, d), jnp.float32), d)
        got = np.asarray(Q.quantize(coeffs, method, d)).astype(np.int32)
    assert_tie_equal(got, want, ties, method.name)


def test_dft_f32_band_roundtrip():
    cfg = Configuration(width=40, height=24, block_size=2, dct_size=4,
                        transform="DFT",
                        quantization=QuantizationMethod("none"))
    band = RNG.integers(0, 256, (24, 40)).astype(np.int64)
    levels = band_ops.encode_band_levels(band, cfg, dtype=np.float32)
    recon = np.asarray(band_ops.decode_band_levels(
        np.asarray(levels), cfg, dtype=np.float32))
    # rounding-quantized real-DFT round trip: subsample-mean then inflate is
    # the only loss, identical to the f64 parity behavior within +-1
    parity = np.asarray(band_ops.decode_band_levels(
        np.asarray(band_ops.encode_band_levels(band, cfg)), cfg))
    assert np.abs(recon.astype(int) - parity.astype(int)).max() <= 1
