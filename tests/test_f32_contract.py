"""The f32 programs the GPU runs, against the independent f64 oracle.

Cross-path f32 contract (jpeg_tpu/utils/parity.py): an f32 evaluation of
the coefficient path agrees with the exact f64 reference bitwise EXCEPT at
positions where the f64 pre-round value sits within the f32 accumulation
error of an exact half-integer ``round()`` tie — there they may differ by
exactly 1.

The suite pins x64 on for parity mode (tests/conftest.py), while the
production programs trace with x64 off (int32 dequantization, f32
defaults), so every test here runs under ``jax.enable_x64(False)``.  Every
test draws its inputs from its own seeded Generator so a failure
reproduces standalone, in any suite order.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jpeg_tpu.config import Configuration, QuantizationMethod
from jpeg_tpu.ops import band as band_ops
from jpeg_tpu.ops import blocks as B
from jpeg_tpu.ops import quantize as Q
from jpeg_tpu.ops import transform as T
from jpeg_tpu.utils import parity as PAR


@pytest.fixture(autouse=True)
def production_f32():
    with jax.enable_x64(False):
        yield


def _f32_encode(cfg, band):
    fn = jax.jit(band_ops.make_encode(band_ops.config_key(cfg), "float32"))
    return np.asarray(fn(jnp.asarray(band, jnp.int32)))


def _f32_decode(cfg, levels):
    fn = jax.jit(band_ops.make_decode(band_ops.config_key(cfg), "float32"))
    return np.asarray(fn(jnp.asarray(levels, jnp.int32)))


def _check_both_ways(cfg, band, label=""):
    lv = _f32_encode(cfg, band)
    lv_ref, enc_ties = PAR.encode_reference_and_ties(cfg, band)
    PAR.assert_tie_equal(lv, lv_ref, enc_ties, f"encode f32 vs f64 {label}")
    px = _f32_decode(cfg, lv)
    px_ref, dec_ties = PAR.decode_reference_and_ties(cfg, lv)
    PAR.assert_tie_equal(px, px_ref, dec_ties, f"decode f32 vs f64 {label}")
    return lv, px


def test_production_mode_is_f32():
    assert not jax.config.jax_enable_x64
    assert band_ops.default_dtype() == jnp.float32


@pytest.mark.parametrize("method", [
    QuantizationMethod("none"),
    QuantizationMethod("discard", keep=3),
    QuantizationMethod("divide", divisor=100),
    QuantizationMethod("qtable"),
], ids=lambda m: m.name)
@pytest.mark.parametrize("hw,bs", [
    ((8, 8), 1),            # one block
    ((8, 56), 1),           # one block row
    ((64, 1024), 2),        # divisible: separable two-stage contraction
    ((61, 1027), 2),        # ragged: subsample + DCT pad, bs=1 factor
], ids=["one", "row", "divisible", "ragged"])
def test_encode_f32_matches_f64(method, hw, bs):
    h, w = hw
    rng = np.random.default_rng(
        zlib.crc32(f"enc-{method.name}-{h}x{w}".encode()))
    cfg = Configuration(width=w, height=h, block_size=bs, dct_size=8,
                        quantization=method)
    band = rng.integers(0, 256, (h, w))
    lv_ref, ties = PAR.encode_reference_and_ties(cfg, band)
    PAR.assert_tie_equal(_f32_encode(cfg, band), lv_ref, ties,
                         f"{method.name} {hw}")


@pytest.mark.parametrize("method", [
    QuantizationMethod("none"),
    QuantizationMethod("divide", divisor=40),
    QuantizationMethod("qtable"),
], ids=lambda m: m.name)
def test_decode_f32_matches_f64(method):
    rng = np.random.default_rng(zlib.crc32(f"dec-{method.name}".encode()))
    cfg = Configuration(width=88, height=24, block_size=1, dct_size=8,
                        quantization=method)
    band = rng.integers(0, 256, (24, 88))
    lv, _ = PAR.encode_reference_and_ties(cfg, band)
    px_ref, ties = PAR.decode_reference_and_ties(cfg, lv)
    PAR.assert_tie_equal(_f32_decode(cfg, lv), px_ref, ties, method.name)


def test_decode_roundtrip_quality():
    # Unquantized encode+decode through the f32 programs reconstructs the
    # band to within rounding.
    rng = np.random.default_rng(41)
    cfg = Configuration(width=64, height=64, block_size=1, dct_size=8,
                        quantization=QuantizationMethod("none"))
    band = rng.integers(0, 256, (64, 64))
    recon = _f32_decode(cfg, _f32_encode(cfg, band))
    assert np.abs(recon - band).max() <= 1


@pytest.mark.parametrize("d,transform", [
    (2, "DCT"), (4, "DCT"), (8, "DCT"),
    # d=24 is BASELINE config 3's shape family
    (24, "DCT"), (8, "DFT"),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_band_encode_decode_f32_matches_f64(d, transform, seed):
    """Ragged geometry (padding at both the subsample and DCT-pad stages)
    through both f32 programs, checked against the f64 oracle."""
    rng = np.random.default_rng(
        zlib.crc32(f"packed-{d}-{transform}-{seed}".encode()))
    w = d * 2 * 5 + 3
    h = d * 2 * 3 + 1
    cfg = Configuration(width=w, height=h, block_size=2, dct_size=d,
                        transform=transform,
                        quantization=QuantizationMethod("divide", divisor=40))
    _check_both_ways(cfg, rng.integers(0, 256, (h, w)), f"d={d} {transform}")


def test_tie_contract_rejects_non_tie_mismatch():
    # The contract helper must actually catch a genuine (non-tie) bug.
    rng = np.random.default_rng(23)
    cfg = Configuration(width=83, height=49, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("divide", divisor=40))
    lv = _f32_encode(cfg, rng.integers(0, 256, (49, 83)))
    px_ref, ties = PAR.decode_reference_and_ties(cfg, lv)
    broken = px_ref.copy()
    broken[0, 0] += 7            # not a +-1 tie flip
    assert PAR.tie_diff_report(broken, px_ref, ties) is not None


def test_combined_operator_paths_match_f64():
    """Divisible geometry takes the combined (joint or separable) operator
    in both directions, for DCT and DFT and several quantizers."""
    rng = np.random.default_rng(5)
    cases = [
        dict(width=128, height=96, block_size=2, dct_size=8,
             quantization=QuantizationMethod("qtable")),
        dict(width=64, height=32, block_size=1, dct_size=8,
             quantization=QuantizationMethod("divide", divisor=40)),
        dict(width=96, height=48, block_size=2, dct_size=4,
             quantization=QuantizationMethod("none")),
        dict(width=128, height=64, block_size=2, dct_size=8,
             transform="DFT", quantization=QuantizationMethod("none")),
    ]
    for kw in cases:
        cfg = Configuration(**kw)
        _check_both_ways(cfg, rng.integers(0, 256, (cfg.height, cfg.width)),
                         str(kw))


def test_padded_shape_takes_separable_pad_path():
    # 50x34 with bs=2 -> 25x17 subsampled, needs DCT padding: the
    # subsample + DCT-pad + separable contraction path.
    rng = np.random.default_rng(6)
    cfg = Configuration(width=50, height=34, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    assert band_ops.make_encode(band_ops.config_key(cfg), "float32").separable
    _check_both_ways(cfg, rng.integers(0, 256, (34, 50)))


def test_combined_decode_matches_twostep():
    """On divisible geometry the decode dual (dezigzag+IDCT+inflate as ONE
    matmul) must equal the explicit two-step chain under the tie contract,
    DCT and DFT."""
    rng = np.random.default_rng(9)
    cases = [
        dict(width=128, height=96, block_size=2, dct_size=8,
             quantization=QuantizationMethod("qtable")),
        dict(width=96, height=48, block_size=3, dct_size=4,
             quantization=QuantizationMethod("divide", divisor=40)),
        dict(width=128, height=64, block_size=2, dct_size=8,
             transform="DFT", quantization=QuantizationMethod("none")),
    ]
    for kw in cases:
        cfg = Configuration(**kw)
        d, bs = cfg.dct_size, cfg.block_size
        lv = _f32_encode(cfg, rng.integers(0, 256, (cfg.height, cfg.width)))
        # explicit two-step reference: deq -> IDCT -> round/clamp ->
        # deblockify -> inflate (the pre-combined decode chain)
        deq = Q.dequantize(jnp.asarray(lv, jnp.int32), cfg.quantization, d)
        if cfg.transform == "DCT":
            pix = T.izigzag_idct2(deq.astype(jnp.float32), d)
        else:
            pix = T.izigzag_idft2_real(deq.astype(jnp.float32), d)
        pix = jnp.clip(jnp.round(pix), 0, 255).astype(jnp.int32)
        plane = B.deblockify(pix.reshape(
            cfg.blocks_high, cfg.blocks_wide, d, d))
        want = np.asarray(B.inflate(plane, bs))
        _, ties = PAR.decode_reference_and_ties(cfg, lv)
        PAR.assert_tie_equal(_f32_decode(cfg, lv), want, ties,
                             f"combined vs twostep {kw}")
