"""API edge cases around the int16 level transport."""
import numpy as np
import pytest

from jpeg_tpu import (BadRleCodeError, Configuration, QuantizationMethod,
                      compress_ycbcr, decompress_to_ycbcr)


def test_overrange_amplitude_rejected():
    # dct_size 24 with raw rounding: the DC coefficient of a bright plane is
    # ~255*576 >> 16383, unrepresentable in the 4-bit-size RLE code
    # (reference util.py:162-174) -> must raise, not wrap through int16.
    cfg = Configuration(width=48, height=48, block_size=1, dct_size=24,
                        quantization=QuantizationMethod("none"))
    img = np.full((48, 48, 3), 200, dtype=np.uint8)
    with pytest.raises(BadRleCodeError):
        compress_ycbcr(img, cfg)


def test_device_entropy_path_matches_host(monkeypatch):
    # Force the fully-on-device entropy path (GPU-only by policy) and check
    # the container bytes are identical to the host entropy path.
    from jpeg_tpu import api
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    cfg = Configuration(width=56, height=40, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    host_blob = compress_ycbcr(img, cfg)
    monkeypatch.setattr(api, "_use_device_entropy", lambda: True)
    dev_blob = compress_ycbcr(img, cfg)
    assert dev_blob == host_blob


def test_device_decode_path_matches_host(monkeypatch):
    from jpeg_tpu import api
    from jpeg_tpu.entropy import native_codec
    if not native_codec.available():
        pytest.skip("native codec unavailable")
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    cfg = Configuration(width=56, height=40, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    blob = compress_ycbcr(img, cfg)
    host_out = decompress_to_ycbcr(blob)
    monkeypatch.setattr(api, "_use_device_entropy", lambda: True)
    dev_out = decompress_to_ycbcr(blob)
    np.testing.assert_array_equal(dev_out, host_out)


def test_device_entropy_path_rejects_overrange(monkeypatch):
    from jpeg_tpu import api
    monkeypatch.setattr(api, "_use_device_entropy", lambda: True)
    cfg = Configuration(width=48, height=48, block_size=1, dct_size=24,
                        quantization=QuantizationMethod("none"))
    img = np.full((48, 48, 3), 200, dtype=np.uint8)
    with pytest.raises(BadRleCodeError):
        compress_ycbcr(img, cfg)


def test_amplitude_at_limit_roundtrips():
    # divide quantizer keeps the same plane well inside the representable
    # range and round-trips.
    cfg = Configuration(width=48, height=48, block_size=1, dct_size=24,
                        quantization=QuantizationMethod("divide", divisor=40))
    img = np.full((48, 48, 3), 200, dtype=np.uint8)
    out = decompress_to_ycbcr(compress_ycbcr(img, cfg))
    assert out.shape == img.shape
    assert np.abs(out.astype(int) - 200).max() <= 2


def test_encode_levels_rejects_int64_overrange():
    from jpeg_tpu import entropy
    with pytest.raises(BadRleCodeError):
        entropy.encode_levels(np.array([[2 ** 32, 1]], dtype=np.int64))
    with pytest.raises(TypeError):
        entropy.encode_levels(np.array([[1.5]]))


def test_encode_levels_rejects_uint32_overrange():
    from jpeg_tpu import entropy
    bad = np.zeros((1, 4), dtype=np.uint32)
    bad[0, 0] = 2 ** 32 - 16383     # would wrap to -16383 through int32
    with pytest.raises(BadRleCodeError):
        entropy.encode_levels(bad)


def test_mismatched_dims_rejected():
    from jpeg_tpu.config import BadArrayShapeError
    from jpeg_tpu import compress_band
    cfg = Configuration(width=8, height=8, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    img16 = np.zeros((16, 16, 3), np.uint8)
    with pytest.raises(BadArrayShapeError):
        compress_ycbcr(img16, cfg)
    with pytest.raises(BadArrayShapeError):
        compress_band(np.zeros((16, 16)), cfg)
    # transposed dims (the easy real-world mistake)
    cfg2 = Configuration(width=8, height=16, block_size=2, dct_size=8)
    with pytest.raises(BadArrayShapeError):
        compress_band(np.zeros((8, 16)), cfg2)


def test_huge_divisor_decode_does_not_wrap(monkeypatch):
    # divisor 200000: level*divisor exceeds int32; fast (f32) mode must not
    # wrap.  Compare against the x64 parity decode.
    import jax
    from jpeg_tpu import compress_band, decompress_band
    cfg = Configuration(width=16, height=16, block_size=1, dct_size=8,
                        quantization=QuantizationMethod("divide",
                                                        divisor=200000))
    band = np.full((16, 16), 255, np.int64)
    stream = compress_band(band, cfg)
    truth = np.asarray(decompress_band(stream, cfg, dtype=np.float64))
    fast = np.asarray(decompress_band(stream, cfg, dtype=np.float32))
    assert np.abs(fast.astype(int) - truth.astype(int)).max() <= 1


def test_int64_min_rejected():
    from jpeg_tpu import entropy
    bad = np.zeros((1, 4), dtype=np.int64)
    bad[0, 0] = np.iinfo(np.int64).min
    with pytest.raises(BadRleCodeError):
        entropy.encode_levels(bad)


def test_garbage_container_bytes_never_crash():
    import struct
    from jpeg_tpu.config import (BadQuantizationError, BadRleCodeError,
                                 BadStreamError, BadArrayShapeError)
    rng = np.random.default_rng(8)
    ok_types = (struct.error, KeyError, ValueError, UnicodeDecodeError,
                BadQuantizationError, BadRleCodeError, BadStreamError,
                BadArrayShapeError)
    for n in (0, 1, 5, 14, 40, 300):
        for _ in range(6):
            blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            try:
                out = decompress_to_ycbcr(blob)
                assert out.ndim == 3          # lucky parse must still be sane
            except ok_types:
                pass                          # structured failure is fine


def test_compress_many_matches_serial():
    from jpeg_tpu import api
    cfg = Configuration(width=32, height=24, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
            for _ in range(5)]
    want = [api.compress_ycbcr(im, cfg) for im in imgs]
    for depth in (1, 2, 4, 16):
        assert api.compress_many(imgs, cfg, depth=depth) == want
    recon = api.decompress_many(want, depth=3)
    for r, blob in zip(recon, want):
        np.testing.assert_array_equal(r, api.decompress_to_ycbcr(blob))
    with pytest.raises(ValueError):
        api.compress_many(imgs, cfg, depth=0)
    assert api.compress_many([], cfg) == []


def test_decompress_many_mixed_configs():
    """The decode pipeline handles heterogeneous blobs (different image
    sizes/configs interleaved): each blob parses its own config, so the
    in-flight states may use different executables."""
    from jpeg_tpu import api
    rng = np.random.default_rng(9)
    blobs = []
    for w, h, d in [(32, 24, 8), (48, 48, 4), (32, 24, 8), (16, 16, 8)]:
        q = QuantizationMethod("qtable" if d == 8 else "divide",
                               **({} if d == 8 else {"divisor": 50}))
        cfg = Configuration(width=w, height=h, block_size=2, dct_size=d,
                            quantization=q)
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        blobs.append(api.compress_ycbcr(img, cfg))
    recon = api.decompress_many(blobs, depth=2)
    for r, blob in zip(recon, blobs):
        np.testing.assert_array_equal(r, api.decompress_to_ycbcr(blob))


def test_decompress_to_device_matches_host_pull():
    """decompress_to_device returns the un-pulled device planes; pulling
    them equals decompress_to_ycbcr (the device-resident consumer form —
    downstream device stages chain without the host round trip)."""
    import numpy as np
    import jpeg_tpu
    from jpeg_tpu import (Configuration, QuantizationMethod, compress_ycbcr,
                          decompress_to_device, decompress_to_ycbcr)
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (24, 40, 3), np.uint8)
    cfg = Configuration(width=40, height=24, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    blob = compress_ycbcr(img, cfg)
    dev = decompress_to_device(blob)
    assert hasattr(dev, "devices")           # a jax Array, not numpy
    got = np.asarray(dev).transpose(1, 2, 0)
    np.testing.assert_array_equal(got, decompress_to_ycbcr(blob))
