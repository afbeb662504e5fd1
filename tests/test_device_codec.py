"""Device-side entropy encoder vs the host codec: bit-identical streams."""
import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from jpeg_tpu.entropy import device_codec as DC
from jpeg_tpu.entropy import numpy_codec as NC

RNG = np.random.default_rng(11)


def _device_bytes(levels):
    stream, blk_bytes = jax.jit(DC.encode_stream)(jnp.asarray(levels))
    total = int(np.asarray(blk_bytes).sum())
    return np.asarray(stream)[:total].tobytes(), np.asarray(blk_bytes)


@pytest.mark.parametrize("L", [16, 64, 576])
def test_random_sparse_matches_host(L):
    for density in (0.0, 0.05, 0.3, 1.0):
        levels = np.zeros((37, L), dtype=np.int32)
        mask = RNG.random(levels.shape) < density
        levels[mask] = RNG.integers(-16383, 16384, int(mask.sum()))
        got, blk_bytes = _device_bytes(levels)
        want = NC.encode_levels(levels)
        assert got == want, f"L={L} density={density}"
        # per-block byte counts consistent with one-block encodes
        for i in [0, 17, 36]:
            assert blk_bytes[i] == len(NC.encode_levels(levels[i:i + 1]))


def test_edge_patterns():
    L = 64
    rows = np.zeros((6, L), dtype=np.int32)
    rows[1, 0] = -5
    rows[2, L - 1] = 1                 # 63 zeros -> 4 chains + code
    rows[3, 0] = 16383                 # max amplitude, size 15
    rows[4, 15] = 7                    # run == 15 -> chain + (0, size, amp)
    rows[5, :] = 1                     # fully dense block
    got, _ = _device_bytes(rows)
    assert got == NC.encode_levels(rows)


def test_single_block_and_empty():
    got, _ = _device_bytes(np.zeros((1, 64), np.int32))
    assert got == NC.encode_levels(np.zeros((1, 64), np.int32)) == b"\x00"


def test_bands_split():
    levels = np.zeros((3 * 9, 64), dtype=np.int32)
    mask = RNG.random(levels.shape) < 0.2
    levels[mask] = RNG.integers(-300, 300, int(mask.sum()))
    stream, band_bytes, mx = jax.jit(
        DC.encode_bands_stream, static_argnums=1)(jnp.asarray(levels), 3)
    band_bytes = np.asarray(band_bytes)
    buf = np.asarray(stream)[:band_bytes.sum()].tobytes()
    off = 0
    for b in range(3):
        part = buf[off:off + band_bytes[b]]
        off += band_bytes[b]
        assert part == NC.encode_levels(levels[9 * b:9 * (b + 1)])
    assert int(mx) == int(np.abs(levels).max())


def _device_decode(stream_bytes, num_blocks, L):
    from jpeg_tpu.entropy import native_codec
    if not native_codec.available():
        pytest.skip("native codec unavailable")
    starts = native_codec.scan_offsets(stream_bytes, num_blocks, L)
    buf = np.frombuffer(stream_bytes, np.uint8)
    fn = jax.jit(DC.decode_stream, static_argnums=2)
    return np.asarray(fn(jnp.asarray(buf), jnp.asarray(starts), L))


@pytest.mark.parametrize("L", [16, 64, 576])
def test_device_decode_matches_levels(L):
    for density in (0.0, 0.05, 0.3, 1.0):
        levels = np.zeros((23, L), dtype=np.int32)
        mask = RNG.random(levels.shape) < density
        levels[mask] = RNG.integers(-16383, 16384, int(mask.sum()))
        stream = NC.encode_levels(levels)
        got = _device_decode(stream, 23, L)
        np.testing.assert_array_equal(got, levels)


def test_device_decode_edge_patterns():
    L = 64
    rows = np.zeros((5, L), dtype=np.int32)
    rows[1, 0] = -5
    rows[2, L - 1] = 1
    rows[3, 0] = 16383
    rows[4, 15] = 7
    stream = NC.encode_levels(rows)
    np.testing.assert_array_equal(_device_decode(stream, 5, L), rows)


def test_scan_offsets_validates():
    from jpeg_tpu.config import BadStreamError
    from jpeg_tpu.entropy import native_codec
    if not native_codec.available():
        pytest.skip("native codec unavailable")
    levels = np.zeros((3, 64), np.int32)
    levels[0, 0] = 9
    stream = NC.encode_levels(levels)
    starts = native_codec.scan_offsets(stream, 3, 64)
    assert starts[0] == 0 and starts[1] == 3 and starts[2] == 4
    with pytest.raises(BadStreamError):
        native_codec.scan_offsets(stream[:-1], 3, 64)   # truncated
    with pytest.raises(BadStreamError):
        native_codec.scan_offsets(stream + b"\x00", 3, 64)  # trailing


def test_roundtrip_through_host_decoder():
    levels = np.zeros((25, 64), dtype=np.int32)
    mask = RNG.random(levels.shape) < 0.15
    levels[mask] = RNG.integers(-2000, 2000, int(mask.sum()))
    got, _ = _device_bytes(levels)
    back = NC.decode_levels(got, 25, 64)
    np.testing.assert_array_equal(back, levels)


def test_encode_stream_chunks_matches_one_shot(monkeypatch):
    L = 64
    levels = np.zeros((50, L), dtype=np.int32)
    mask = RNG.random(levels.shape) < 0.25
    levels[mask] = RNG.integers(-900, 900, int(mask.sum()))
    want = NC.encode_levels(levels)
    # default cap: single chunk, same bytes  (eager: jit would cache the
    # first trace across the cap monkeypatch below — production callers key
    # their fn caches on chunk_blocks instead)
    bufs, bb = DC.encode_stream_chunks(jnp.asarray(levels))
    assert bufs.shape[0] == 1
    assert DC.assemble_chunks(bufs, bb, DC.max_chunk_blocks(L)) == want
    # shrink the int32 ceiling so 50 blocks must split into 8 chunks
    monkeypatch.setattr(DC, "_CAP_BITS",
                        (7 * DC.worst_case_block_bytes(L) + 1) * 8)
    m = DC.max_chunk_blocks(L)
    assert m == 7
    bufs, bb = DC.encode_stream_chunks(jnp.asarray(levels))
    assert bufs.shape[0] == -(-50 // m)
    assert DC.assemble_chunks(bufs, bb, m) == want
    # single-shot encode_stream still refuses past the ceiling
    with pytest.raises(ValueError):
        DC.encode_stream(jnp.asarray(levels))


def test_compress_ycbcr_chunked_device_path(monkeypatch):
    """A batch past the (shrunk) int32 ceiling stays on the device-entropy
    path and produces byte-identical containers."""
    from jpeg_tpu import Configuration, QuantizationMethod, api
    cfg = Configuration(width=64, height=48, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    img = RNG.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    want = api.compress_ycbcr(img, cfg)            # host-entropy reference
    monkeypatch.setattr(api, "_use_device_entropy", lambda: True)
    monkeypatch.setattr(DC, "_CAP_BITS",
                        (5 * DC.worst_case_block_bytes(64) + 1) * 8)
    assert DC.max_chunk_blocks(64) == 5            # 36 blocks -> 8 chunks
    assert api.compress_ycbcr(img, cfg) == want


def _levels_of(kind):
    """Content generators for the scatter-encoder and loop-decoder checks:
    the worst cases and boundaries of the per-block stream geometry."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    if kind == "worst_case":               # 185-byte blocks beside an empty
        lv = np.full((9, 64), 16383, np.int32)
        lv[4] = 0
        lv[6] = -16383
    elif kind == "long_runs_L80":          # 79-zero run: 5 chain bytes
        lv = np.zeros((3, 80), np.int32)
        lv[0, 79] = 5
        lv[1, 0] = -3
    elif kind == "long_runs_L144":         # up to 9 chains, two long runs
        lv = np.zeros((8, 144), np.int32)
        lv[1, 143] = 5
        lv[2, 0] = -3
        lv[3, 75] = 7
        lv[3, 143] = -9
        lv[4, 60] = 1                      # exactly 4 chains
        lv[5, 76] = 2                      # 5 chains
    elif kind == "sparse_L144":            # smooth content at dct_size 12
        lv = np.zeros((96, 144), np.int32)
        m = rng.random(lv.shape) < 0.04
        lv[m] = rng.integers(-16383, 16384, int(m.sum()))
    elif kind == "d24":                    # dct_size 24, L = 576
        lv = np.zeros((5, 576), np.int32)
        m = rng.random(lv.shape) < 0.3
        lv[m] = rng.integers(-16383, 16384, int(m.sum()))
    elif kind == "one_block":
        lv = np.zeros((1, 64), np.int32)
        lv[0, :5] = [700, -3, 0, 1, -1]
    elif kind == "all_eob":                # empty band: 1-byte blocks
        lv = np.zeros((200, 64), np.int32)
    elif kind == "unit_straddle":          # worst next to near-empty, n=513
        lv = np.zeros((513, 64), np.int32)
        lv[0::2, :] = 16383
        lv[1::2, 0] = -1
    elif kind == "short_alternating":      # 9 non-zero vs 1-code blocks
        lv = np.zeros((513, 64), np.int32)
        lv[0::2, :7] = 9
        lv[1::2, 0] = -1
    elif kind == "varied_lengths":         # every length class mixed
        lv = np.zeros((64, 64), np.int32)
        for i in range(64):
            k = int(rng.integers(0, 64))
            lv[i, :k] = rng.integers(-50, 50, k)
    elif kind == "ramp":                   # 1027 blocks, first + last slot
        lv = np.zeros((1027, 64), np.int32)
        lv[:, 0] = np.arange(1027) % 1000 - 500
        lv[:, 63] = 3
    elif kind == "short_blocks":           # under 20 coefficients each
        lv = np.zeros((70, 64), np.int32)
        for i in range(70):
            k = int(rng.integers(0, 20))
            lv[i, :k] = rng.integers(-100, 100, k)
    else:
        raise ValueError(kind)
    return lv


_KINDS = ["worst_case", "long_runs_L80", "long_runs_L144", "sparse_L144",
          "d24", "one_block", "all_eob", "unit_straddle",
          "short_alternating", "varied_lengths", "ramp", "short_blocks"]


@pytest.mark.parametrize("kind", _KINDS)
def test_scatter_encode_matches_host(kind):
    """Scatter encoder == host codec bytes, remainder zero, and its
    per-block byte counts match the host stream's block boundaries."""
    lv = _levels_of(kind)
    want = NC.encode_levels(lv)
    buf, bb = jax.jit(DC.encode_stream)(jnp.asarray(lv))
    buf, bb = np.asarray(buf), np.asarray(bb)
    total = int(bb.sum())
    assert buf[:total].tobytes() == want
    assert not buf[total:].any()
    starts = NC.scan_offsets(want, lv.shape[0], lv.shape[1])
    np.testing.assert_array_equal(np.diff(starts, append=len(want)), bb)


@pytest.mark.parametrize("kind", _KINDS)
def test_loop_decode_matches_host(kind):
    """The lock-step while_loop decoder returns the host decoder's levels."""
    lv = _levels_of(kind)
    stream = NC.encode_levels(lv)
    n, L = lv.shape
    starts = NC.scan_offsets(stream, n, L)
    got = jax.jit(DC.decode_stream, static_argnums=2)(
        jnp.asarray(np.frombuffer(stream, np.uint8)), jnp.asarray(starts), L)
    np.testing.assert_array_equal(np.asarray(got), lv)
    np.testing.assert_array_equal(NC.decode_levels(stream, n, L), lv)


def test_device_entropy_pipelined_matches_serial(monkeypatch):
    """compress_many / decompress_many on the device-entropy path equal the
    per-image host-entropy results."""
    from jpeg_tpu import Configuration, QuantizationMethod, api
    cfg = Configuration(width=32, height=32, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    imgs = [RNG.integers(0, 256, (32, 32, 3)).astype(np.uint8)
            for _ in range(3)]
    want = [api.compress_ycbcr(im, cfg) for im in imgs]
    planes = [api.decompress_to_ycbcr(b) for b in want]
    monkeypatch.setattr(api, "_use_device_entropy", lambda: True)
    assert api.compress_many(imgs, cfg) == want
    for got, p in zip(api.decompress_many(want), planes):
        np.testing.assert_array_equal(got, p)
