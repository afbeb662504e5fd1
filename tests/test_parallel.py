"""Sharded-path tests on the 8-device virtual CPU mesh.

Validates that mesh-sharded execution is bit-identical to the single-device
path (the codec's determinism/"race" test, SURVEY.md §5), that the row-band
bitstream stitch reproduces the serial stream byte-for-byte, and that the
device-side size estimator matches the real entropy coder exactly.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from jpeg_tpu import (Configuration, QuantizationMethod, compress_ycbcr,
                      decompress_to_ycbcr, parallel)
from jpeg_tpu import entropy
from jpeg_tpu.ops.band import encode_band_levels

RNG = np.random.default_rng(42)


def _cfg(w, h, **kw):
    kw.setdefault("quantization", QuantizationMethod("qtable"))
    return Configuration(width=w, height=h, **kw)


def test_factorize():
    assert parallel.factorize(8) == (1, 8)
    assert parallel.factorize(4) == (1, 4)
    assert parallel.factorize(2) == (1, 2)
    assert parallel.factorize(1) == (1, 1)
    assert parallel.factorize(6) == (3, 2)
    assert parallel.factorize(12, max_band=4) == (3, 4)


def test_make_mesh_axes():
    mesh = parallel.make_mesh(8)
    assert mesh.axis_names == ("data", "band")
    assert mesh.devices.size == 8
    mesh2 = parallel.make_mesh(data=2, band=4)
    assert mesh2.devices.shape == (2, 4)


def test_batch_encode_matches_single_device():
    cfg = _cfg(48, 40, block_size=2)
    mesh = parallel.make_mesh(8)
    bands = RNG.integers(0, 256, (4, 40, 48), dtype=np.int32)
    levels, nbytes = parallel.encode_batch_levels(bands, cfg, mesh)
    for i in range(4):
        ref = np.asarray(encode_band_levels(bands[i], cfg))
        np.testing.assert_array_equal(levels[i], ref)
    # Device-side size == sum of real per-band stream lengths.
    expect = sum(len(entropy.encode_levels(levels[i])) for i in range(4))
    assert nbytes == expect


def test_block_bytes_match_entropy_coder():
    cfg = _cfg(64, 64, block_size=1, quantization=QuantizationMethod("none"))
    band = RNG.integers(0, 256, (64, 64), dtype=np.int32)
    levels = np.asarray(encode_band_levels(band, cfg))
    got = np.asarray(parallel.block_bytes(jnp.asarray(levels)))
    for i in range(levels.shape[0]):
        assert got[i] == len(entropy.encode_levels(levels[i:i + 1])), i


def test_block_bytes_edge_cases():
    # all-zero block = 1 EOB byte; long zero runs; negative amps; amp=16383
    rows = np.zeros((4, 64), dtype=np.int32)
    rows[1, 0] = -5
    rows[2, 63] = 1          # 63 zeros: 4 chains + code
    rows[3, 0] = 16383       # size 15
    got = np.asarray(parallel.block_bytes(jnp.asarray(rows)))
    for i in range(4):
        assert got[i] == len(entropy.encode_levels(rows[i:i + 1])), i


def test_rowband_stitch_bit_identical():
    cfg = _cfg(40, 8 * 2 * 8, block_size=2)  # 8 block-rows -> one per shard
    mesh = parallel.make_mesh(8)
    plane = RNG.integers(0, 256, (cfg.height, cfg.width), dtype=np.int32)
    sharded = parallel.compress_plane(plane, cfg, mesh)
    serial = entropy.encode_levels(np.asarray(encode_band_levels(plane, cfg)))
    assert sharded == serial


def test_rowband_stitch_uneven_rows():
    # 5 block-rows across 8 shards: some shards empty, bounds clamp.
    cfg = _cfg(24, 5 * 2 * 8, block_size=2)
    mesh = parallel.make_mesh(8)
    plane = RNG.integers(0, 256, (cfg.height, cfg.width), dtype=np.int32)
    sharded = parallel.compress_plane(plane, cfg, mesh)
    serial = entropy.encode_levels(np.asarray(encode_band_levels(plane, cfg)))
    assert sharded == serial


def test_compress_batch_roundtrip_matches_api():
    cfg = _cfg(32, 24, block_size=2)
    mesh = parallel.make_mesh(8)
    imgs = RNG.integers(0, 256, (3, 24, 32, 3), dtype=np.uint8)
    blobs = parallel.compress_batch(imgs, cfg, mesh)
    for i in range(3):
        assert blobs[i] == compress_ycbcr(imgs[i], cfg)
    recon = parallel.decompress_batch(blobs, mesh)
    assert recon.shape == imgs.shape
    for i in range(3):
        np.testing.assert_array_equal(recon[i],
                                      np.asarray(decompress_to_ycbcr(blobs[i])))


def test_compress_batch_rejects_bad_shape():
    mesh = parallel.make_mesh(8)
    cfg = _cfg(8, 8)
    with pytest.raises(ValueError):
        parallel.compress_batch(np.zeros((2, 8, 8), np.uint8), cfg, mesh)


def test_graft_entry_single():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_graft", "/root/repo/__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (32 * 32, 64)
    assert out.dtype == jnp.int32


def test_graft_dryrun_multichip():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_graft", "/root/repo/__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)
    mod.dryrun_multichip(2)


def test_device_entropy_sharded_stitch():
    # Per-shard on-device entropy under shard_map == serial stream.
    cfg = _cfg(40, 8 * 2 * 8, block_size=2)
    mesh = parallel.make_mesh(8)
    plane = RNG.integers(0, 256, (cfg.height, cfg.width), dtype=np.int32)
    got = parallel.compress_plane(plane, cfg, mesh, device_entropy=True)
    want = entropy.encode_levels(np.asarray(encode_band_levels(plane, cfg)))
    assert got == want


def test_device_entropy_sharded_stitch_uneven():
    # num_blocks (5*3=15 block-rows of 2 blocks) not divisible by 8 shards:
    # zero-block padding EOB bytes must be dropped from the tail.
    cfg = _cfg(24, 5 * 2 * 8, block_size=2)
    mesh = parallel.make_mesh(8)
    plane = RNG.integers(0, 256, (cfg.height, cfg.width), dtype=np.int32)
    got = parallel.compress_plane(plane, cfg, mesh, device_entropy=True)
    want = entropy.encode_levels(np.asarray(encode_band_levels(plane, cfg)))
    assert got == want


def test_fullhd_rowband_pipeline():
    # 1080p plane through the row-band + stitch path (f32 fast mode).
    cfg = Configuration(width=1920, height=1080, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    mesh = parallel.make_mesh(8)
    y, x = np.mgrid[0:1080, 0:1920]
    plane = np.clip(128 + 80 * np.sin(x / 37.0) * np.cos(y / 23.0),
                    0, 255).astype(np.int32)
    got = parallel.compress_plane(plane, cfg, mesh, dtype=np.float32)
    want = entropy.encode_levels(
        np.asarray(encode_band_levels(plane, cfg, dtype=np.float32)))
    assert got == want


def test_compress_batch_device_entropy_matches_host():
    cfg = _cfg(32, 24, block_size=2)
    mesh = parallel.make_mesh(8)
    imgs = RNG.integers(0, 256, (3, 24, 32, 3), dtype=np.uint8)
    host_blobs = parallel.compress_batch(imgs, cfg, mesh, device_entropy=False)
    dev_blobs = parallel.compress_batch(imgs, cfg, mesh, device_entropy=True)
    assert dev_blobs == host_blobs


@pytest.mark.skipif(not __import__("os").environ.get("JPEG_TPU_BIG_TESTS"),
                    reason="set JPEG_TPU_BIG_TESTS=1 for 4K-scale tests")
def test_4k_batch_rowband_stitch():
    # BASELINE.json config 5: 4K image set through the sharded mesh path.
    cfg = Configuration(width=3840, height=2160, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    mesh = parallel.make_mesh(8)
    y, x = np.mgrid[0:2160, 0:3840]
    plane = np.clip(128 + 80 * np.sin(x / 41.0) * np.cos(y / 29.0),
                    0, 255).astype(np.int32)
    got = parallel.compress_plane(plane, cfg, mesh, dtype=np.float32)
    want = entropy.encode_levels(
        np.asarray(encode_band_levels(plane, cfg, dtype=np.float32)))
    assert got == want
    imgs = np.repeat(plane[None, :, :, None], 3, axis=3).astype(np.uint8)[:1]
    blobs = parallel.compress_batch(imgs, cfg, mesh, dtype=np.float32)
    assert blobs[0] == compress_ycbcr(imgs[0], cfg, dtype=np.float32)


def test_device_entropy_plane_rejects_overrange():
    # Confirmed review finding: this path used to emit a silently-corrupt
    # stream for unrepresentable amplitudes.
    from jpeg_tpu.config import BadRleCodeError
    cfg = Configuration(width=48, height=48, block_size=1, dct_size=24,
                        quantization=QuantizationMethod("none"))
    mesh = parallel.make_mesh(8)
    plane = np.full((48, 48), 200, dtype=np.int32)
    with pytest.raises(BadRleCodeError):
        parallel.compress_plane(plane, cfg, mesh, device_entropy=True)


def test_multihost_indivisible_height():
    # height=100 not divisible by 8 devices: fit_spec must fall back to a
    # replicated dim instead of a sharding error (single-process).
    from jpeg_tpu.parallel import multihost
    from jpeg_tpu import entropy as E
    cfg = _cfg(32, 100, block_size=2)
    plane = RNG.integers(0, 256, (100, 32), dtype=np.int32)
    got = multihost.compress_plane_distributed(plane, cfg)
    want = E.encode_levels(np.asarray(encode_band_levels(plane, cfg)))
    assert got == want


def test_make_mesh_single_axis_honored():
    mesh = parallel.make_mesh(data=4)
    assert mesh.devices.shape == (4, 2)
    mesh2 = parallel.make_mesh(band=2)
    assert mesh2.devices.shape == (4, 2)
    with pytest.raises(ValueError):
        parallel.make_mesh(n_devices=8, data=3)


def test_decompress_batch_device_entropy_matches_host():
    from jpeg_tpu.entropy import native_codec
    if not native_codec.available():
        pytest.skip("native codec unavailable")
    cfg = _cfg(32, 24, block_size=2)
    mesh = parallel.make_mesh(8)
    imgs = RNG.integers(0, 256, (3, 24, 32, 3), dtype=np.uint8)
    blobs = parallel.compress_batch(imgs, cfg, mesh, device_entropy=False)
    host = parallel.decompress_batch(blobs, mesh, device_entropy=False)
    dev = parallel.decompress_batch(blobs, mesh, device_entropy=True)
    np.testing.assert_array_equal(dev, host)


@pytest.mark.parametrize("trial", range(8))
def test_fuzz_sharded_equals_serial(trial):
    """Random geometry through both sharded encode paths == serial bytes."""
    rng = np.random.default_rng(4200 + trial)
    w = int(rng.integers(1, 70))
    h = int(rng.integers(1, 70))
    bs = int(rng.integers(1, 6))
    d = int(rng.choice([2, 3, 4, 8]))
    qn = str(rng.choice(["none", "divide", "qtable"]))
    if qn == "qtable":
        d = 8
    kw = {"divisor": 40} if qn == "divide" else {}
    cfg = Configuration(width=w, height=h, block_size=bs, dct_size=d,
                        quantization=QuantizationMethod(qn, **kw))
    mesh = parallel.make_mesh(8)
    plane = rng.integers(0, 256, (h, w)).astype(np.int64)
    serial = entropy.encode_levels(np.asarray(encode_band_levels(plane, cfg)))
    assert parallel.compress_plane(plane, cfg, mesh) == serial
    assert parallel.compress_plane(plane, cfg, mesh,
                                   device_entropy=True) == serial


def test_decompress_plane_matches_decompress_band():
    """decompress_plane (sharded decode of one plane) == decompress_band,
    both the device-bit-parse and host-entropy variants."""
    from jpeg_tpu import api
    cfg = _cfg(96, 8 * 2 * 8, block_size=2)
    mesh = parallel.make_mesh(8)
    plane = RNG.integers(0, 256, (cfg.height, cfg.width), dtype=np.int32)
    stream = api.compress_band(plane, cfg)
    want = api.decompress_band(stream, cfg)
    dev = parallel.decompress_plane(stream, cfg, mesh, device_entropy=True)
    host = parallel.decompress_plane(stream, cfg, mesh, device_entropy=False)
    np.testing.assert_array_equal(dev, want)
    np.testing.assert_array_equal(host, want)


def test_decompress_plane_uneven_blocks():
    # 15 block-rows over 8 shards: the block count pads to a multiple of 8
    # (dummy starts decode as all-zero blocks, dropped before the IDCT)
    # and the row-band decode still matches bit-exactly.
    from jpeg_tpu import api
    cfg = _cfg(24, 5 * 2 * 8, block_size=2)
    mesh = parallel.make_mesh(8)
    plane = RNG.integers(0, 256, (cfg.height, cfg.width), dtype=np.int32)
    stream = api.compress_band(plane, cfg)
    want = api.decompress_band(stream, cfg)
    got = parallel.decompress_plane(stream, cfg, mesh, device_entropy=True)
    np.testing.assert_array_equal(got, want)


def test_decompress_plane_fullhd():
    # encode via the sharded device-entropy path, decode via the sharded
    # device-bit-parse path: a full sharded round trip on a 1080p plane.
    cfg = Configuration(width=1920, height=1080, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    mesh = parallel.make_mesh(8)
    y, x = np.mgrid[0:1080, 0:1920]
    plane = np.clip(128 + 80 * np.sin(x / 37.0) * np.cos(y / 23.0),
                    0, 255).astype(np.int32)
    stream = parallel.compress_plane(plane, cfg, mesh, dtype=np.float32,
                                    device_entropy=True)
    from jpeg_tpu import api
    want = api.decompress_band(stream, cfg, dtype=np.float32)
    got = parallel.decompress_plane(stream, cfg, mesh, dtype=np.float32,
                                    device_entropy=True)
    np.testing.assert_array_equal(got, want)


def test_shard_stream_slices_addressable_bytes():
    """The batch-decode stream upload is SHARDED: each device addresses only
    ~total/ndev bytes (pow2-bucketed), never the whole replicated batch
    stream.  Byte-aligned blocks (reference
    rle_byte_stream.py:54-56) make the contiguous flat-block split exact."""
    from jpeg_tpu.parallel.sharded import _shard_stream_slices
    from jpeg_tpu.entropy import numpy_codec as NC
    nb, L = 64, 64
    rng = np.random.default_rng(11)
    streams, scans = [], []
    for _ in range(6):                       # 6 bands, 64 blocks each
        lv = np.zeros((nb, L), np.int32)
        m = rng.random(lv.shape) < 0.4
        lv[m] = rng.integers(-2000, 2000, int(m.sum()))
        s = entropy.encode_levels(lv)
        streams.append(s)
        scans.append(entropy.scan_offsets(s, nb, L))
    total = sum(len(s) for s in streams)
    ndev = 8
    slices, local = _shard_stream_slices(streams, scans, ndev)
    assert slices.shape[0] == ndev and local.shape == (ndev, 6 * nb // ndev)
    # each shard addresses far less than the whole stream
    assert slices.shape[1] * 4 <= total
    # slice + local offsets reconstruct every block's bytes exactly
    buf = b"".join(streams)
    gstarts = np.concatenate(
        [sc + off for sc, off in zip(
            scans, np.cumsum([0] + [len(s) for s in streams[:-1]]))])
    ends = np.concatenate([gstarts[1:], [total]])
    nd = local.shape[1]
    for k in range(ndev):
        for j in range(nd):
            g = k * nd + j
            blk = buf[gstarts[g]:ends[g]]
            lo = local[k, j]
            assert slices[k, lo:lo + len(blk)].tobytes() == blk
        # the slice width covers the shard's last block
        assert local[k, -1] < slices.shape[1]


def test_shard_stream_slices_uneven_blocks():
    """Flat block count not divisible by ndev: dummy tail blocks decode as
    single EOB bytes and are dropped."""
    from jpeg_tpu.parallel.sharded import _shard_stream_slices
    nb, L = 5, 16                            # 3 bands x 5 blocks = 15 % 8 != 0
    streams, scans = [], []
    for i in range(3):
        lv = np.zeros((nb, L), np.int32)
        lv[:, 0] = i + 1
        s = entropy.encode_levels(lv)
        streams.append(s)
        scans.append(entropy.scan_offsets(s, nb, L))
    slices, local = _shard_stream_slices(streams, scans, 8)
    assert local.shape == (8, 2)             # 15 -> 16 blocks, 2 per shard
    # the dummy block's slice byte is 0x00 = immediate EOB
    k, j = 7, 1
    assert slices[k, local[k, j]] == 0


def test_decompress_plane_distributed_single_process():
    """Single process: the distributed decode dual degenerates to the
    sharded plane decode, byte-equal to the serial decoder."""
    from jpeg_tpu import api
    from jpeg_tpu.parallel import multihost
    cfg = _cfg(64, 48, block_size=2)
    plane = RNG.integers(0, 256, (48, 64)).astype(int)
    stream = api.compress_band(plane, cfg)
    mesh = parallel.make_mesh(8)
    got = multihost.decompress_plane_distributed(stream, cfg, mesh)
    np.testing.assert_array_equal(got, api.decompress_band(stream, cfg))


@pytest.mark.parametrize("block_rows", [8, 5])
def test_plane_paths_split_over_every_device(block_rows):
    """The plane's levels and decoded rows land split over all 8 devices,
    also when the block count is not a multiple of 8 (it pads with zero
    blocks, dropped again before the stitch and the IDCT)."""
    from chip_smoke import split_over
    from jpeg_tpu import api
    from jpeg_tpu.ops import band as band_ops
    from jpeg_tpu.parallel import sharded
    cfg = _cfg(24, block_rows * 2 * 8, block_size=2)
    mesh = parallel.make_mesh(8)
    plane = RNG.integers(0, 256, (cfg.height, cfg.width), dtype=np.int32)
    f32 = np.dtype(np.float32)
    lv = sharded._plane_encode_fn(band_ops.config_key(cfg), f32.name, mesh,
                                  plane.shape)(plane)
    assert lv.shape[0] == 16 and split_over(lv) == 8
    assert not np.asarray(lv)[cfg.num_blocks:].any()
    stream = parallel.compress_plane(plane, cfg, mesh, dtype=f32,
                                     device_entropy=True)
    rows = sharded._decode_plane_device(stream, cfg, mesh, f32)
    assert split_over(rows) == 8
    np.testing.assert_array_equal(
        np.asarray(rows), api.decompress_band(stream, cfg, dtype=f32))


def test_batch_paths_split_over_every_device():
    """Batch coefficient levels and device-decoded planes split over the
    mesh's band axis."""
    from chip_smoke import split_over
    from jpeg_tpu.ops import band as band_ops
    from jpeg_tpu.parallel import sharded
    cfg = _cfg(32, 64, block_size=2)
    mesh = parallel.make_mesh(8)
    imgs = RNG.integers(0, 256, (2, 64, 32, 3), dtype=np.uint8)
    bands = imgs.transpose(0, 3, 1, 2).reshape(6, 64, 32)
    lv = sharded._batch_encode_fn(band_ops.config_key(cfg), "float64", mesh,
                                  bands.shape, with_stats=False)(bands)
    assert split_over(lv) == 8
    blobs = parallel.compress_batch(imgs, cfg, mesh)
    from jpeg_tpu.container import read_data
    streams = [s for _, d in map(read_data, blobs) for s in (d.y, d.cb, d.cr)]
    planes = sharded._decompress_batch_device(streams, cfg, mesh, 2, None)
    assert split_over(planes) == 8
    np.testing.assert_array_equal(
        np.asarray(planes).transpose(0, 2, 3, 1),
        parallel.decompress_batch(blobs, mesh, device_entropy=False))

