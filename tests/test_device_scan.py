"""On-device boundary scan (entropy/device_scan.py): parity with the host
scanners on valid streams, single-flag rejection of everything malformed,
and exact error passthrough via the hybrid wrapper.

The device scan replaces the last serial host stage of decode (reference
rle_byte_stream.py:74-88 walks the stream one code at a time); its contract
is bit-exact starts when ``ok`` and a host rescan (canonical error) when
not.  Runs on CPU here; chip_smoke.py phase 4 runs it on the GPU.
"""
import numpy as np
import pytest

import jpeg_tpu.entropy as entropy
from jpeg_tpu.config import BadRleCodeError, BadStreamError
from jpeg_tpu.entropy import device_scan as DS
from jpeg_tpu.entropy import numpy_codec as NC


def _rand_levels(rng, n, L, density=0.15, amp=900):
    levels = np.zeros((n, L), dtype=np.int32)
    mask = rng.random((n, L)) < density
    levels[mask] = rng.integers(-amp, amp + 1, size=int(mask.sum()))
    return levels


@pytest.mark.parametrize("n,L,density", [
    (1, 64, 0.2), (37, 64, 0.05), (64, 16, 0.5), (9, 256, 0.02),
    (200, 64, 0.0),      # all-EOB stream: 1-byte blocks
    (5, 1, 0.5),         # dct_size=1: single-coefficient blocks
])
def test_matches_host_scan(n, L, density):
    rng = np.random.default_rng(n * 1000 + L)
    data = NC.encode_levels(_rand_levels(rng, n, L, density))
    starts, ok = DS.scan_offsets_device(data, n, L)
    assert ok
    assert np.array_equal(starts, NC.scan_offsets(data, n, L))


def test_chains_and_extremes():
    # >15-zero runs (chain units), run%15==0 quirk (reference util.py:149-154),
    # max-amplitude codes, trailing-zeros blocks.
    L = 64
    lv = np.zeros((6, L), np.int32)
    lv[0, 63] = 1            # 63 zeros: 4 chains + code
    lv[1, 15] = -5           # run exactly 15: chain + (0,size,amp)
    lv[2, 30] = 16383        # max representable |amp|
    lv[3, :] = -1            # dense block
    lv[4, 0] = 3             # leading code, rest zeros -> immediate EOB
    data = NC.encode_levels(lv)
    starts, ok = DS.scan_offsets_device(data, 6, L)
    assert ok
    assert np.array_equal(starts, NC.scan_offsets(data, 6, L))


def test_rejects_malformed_streams():
    data = NC.encode_levels(np.ones((4, 16), np.int32))
    bad_cases = [
        data[:-1],               # truncated tail
        data[:1],                # truncated mid-block
        data + b"\x00",          # trailing bytes
        data + data,             # trailing blocks
        b"\xff" * 16,            # bad (15, 15) wandering garbage
        b"\x70" * 4,             # (7, 0) invalid code
        b"",                     # empty
    ]
    for bad in bad_cases:
        _, ok = DS.scan_offsets_device(bytes(bad), 4, 16)
        assert not ok, bad[:8]


def test_rejects_coefficient_overflow():
    # A stream whose codes index past L for the declared geometry: encode
    # with L=64, scan claiming L=16.
    lv = np.zeros((1, 64), np.int32)
    lv[0, 40] = 9
    data = NC.encode_levels(lv)
    _, ok = DS.scan_offsets_device(data, 1, 16)
    assert not ok
    with pytest.raises(BadStreamError):
        NC.scan_offsets(data, 1, 16)


def test_hybrid_raises_host_errors():
    data = NC.encode_levels(np.ones((4, 16), np.int32))
    with pytest.raises(BadStreamError):
        DS.scan_offsets_hybrid(data[:-1], 4, 16)
    with pytest.raises(BadStreamError):
        DS.scan_offsets_hybrid(data + b"\x00", 4, 16)
    with pytest.raises(BadRleCodeError):
        DS.scan_offsets_hybrid(b"\x70\x00\x00\x00", 4, 16)
    # valid stream passes through bit-exactly
    assert np.array_equal(DS.scan_offsets_hybrid(data, 4, 16),
                          NC.scan_offsets(data, 4, 16))


def test_fuzz_three_way_with_flag():
    """Differential: device scan vs numpy vs native on random + mutated
    streams, plus the entropy.scan_offsets dispatch under the env flag."""
    rng = np.random.default_rng(42)
    for trial in range(30):
        n = int(rng.integers(1, 40))
        L = int(rng.choice([16, 64]))
        data = NC.encode_levels(
            _rand_levels(rng, n, L, float(rng.uniform(0, 0.4))))
        ref = NC.scan_offsets(data, n, L)
        got, ok = DS.scan_offsets_device(data, n, L)
        assert ok and np.array_equal(got, ref), trial

        # single-byte mutation: both sides must agree on accept/reject,
        # and on the starts when both accept
        if len(data) == 0:
            continue
        mut = bytearray(data)
        i = int(rng.integers(len(mut)))
        mut[i] ^= 1 << int(rng.integers(8))
        mut = bytes(mut)
        try:
            ref_m = NC.scan_offsets(mut, n, L)
            host_ok = True
        except (BadStreamError, BadRleCodeError):
            host_ok = False
        got_m, dev_ok = DS.scan_offsets_device(mut, n, L)
        assert dev_ok == host_ok, (trial, i)
        if host_ok:
            assert np.array_equal(got_m, ref_m), (trial, i)


def test_env_flag_dispatch(monkeypatch):
    monkeypatch.setenv("JPEG_TPU_SCAN", "device")
    lv = _rand_levels(np.random.default_rng(7), 12, 64)
    data = NC.encode_levels(lv)
    assert np.array_equal(entropy.scan_offsets(data, 12, 64),
                          NC.scan_offsets(data, 12, 64))
    with pytest.raises(BadStreamError):
        entropy.scan_offsets(data[:-1], 12, 64)


def test_end_to_end_decode_with_device_scan(monkeypatch):
    """Full container round-trip with the device scan feeding the device
    bit parser: bytes and planes identical to the default path."""
    from jpeg_tpu import (Configuration, QuantizationMethod, compress_ycbcr,
                          decompress_to_ycbcr)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (24, 40, 3), np.uint8)
    cfg = Configuration(width=40, height=24, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    blob = compress_ycbcr(img, cfg)
    base = decompress_to_ycbcr(blob)
    monkeypatch.setenv("JPEG_TPU_SCAN", "device")
    assert np.array_equal(decompress_to_ycbcr(blob), base)


def test_long_blocks_match_host_scan():
    """Blocks far longer than typical (dense max-size codes) next to short
    ones: the walkers' full unit budget, exact host starts."""
    L = 64
    lv = np.zeros((6, L), np.int32)
    lv[2, :] = 16000          # dense max-size block, ~180 bytes
    lv[4, ::3] = -1999
    data = NC.encode_levels(lv)
    assert max(np.diff(NC.scan_offsets(data, 6, L))) > 126
    starts, ok = DS.scan_offsets_device(data, 6, L)
    assert ok
    assert np.array_equal(starts, NC.scan_offsets(data, 6, L))


def test_scan_bands_starts_multiband():
    """One walker table over a 3-band concatenated buffer + three orbit
    chases (the fused foreign-decode's scan): starts match the per-band
    host scans, and a truncated middle band fails the per-band ok."""
    import jax
    import jax.numpy as jnp
    from jpeg_tpu.utils.device import quarter_cap
    rng = np.random.default_rng(11)
    L, nb = 64, 9
    bands = [NC.encode_levels(_rand_levels(rng, nb, L, d))
             for d in (0.1, 0.3, 0.0)]

    def run(bands_bytes):
        buf = b"".join(bands_bytes)
        pad = quarter_cap(len(buf))
        arr = np.zeros(pad, np.uint8)
        arr[:len(buf)] = np.frombuffer(buf, np.uint8)
        ends = np.cumsum([len(b) for b in bands_bytes]).astype(np.int32)
        fn = jax.jit(lambda s, e: DS.scan_bands_starts(s, e, nb, L))
        starts, ok = fn(jnp.asarray(arr), jnp.asarray(ends))
        return np.asarray(starts), bool(ok)

    starts, ok = run(bands)
    assert ok
    offs = np.cumsum([0, len(bands[0]), len(bands[1])])
    want = np.concatenate([NC.scan_offsets(b, nb, L) + o
                           for b, o in zip(bands, offs)])
    assert np.array_equal(starts, want)

    # Truncating the MIDDLE band shifts band 2's start: its orbit (and/or
    # band 1's end check) must fail even though the bytes parse locally.
    _, ok_bad = run([bands[0], bands[1][:-1], bands[2]])
    assert not ok_bad


def test_foreign_decode_one_dispatch(monkeypatch):
    """api one-dispatch foreign decode (scan + parse + IDCT in one
    program): planes identical to the host-scan path, including long
    blocks, and the host scanner's error on malformed data."""
    from jpeg_tpu import (Configuration, QuantizationMethod, compress_ycbcr,
                          decompress_to_ycbcr)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (24, 40, 3), np.uint8)
    cfg = Configuration(width=40, height=24, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("none"))  # long blocks
    blob = compress_ycbcr(img, cfg)
    base = decompress_to_ycbcr(blob)
    monkeypatch.setenv("JPEG_TPU_SCAN", "device")
    assert np.array_equal(decompress_to_ycbcr(blob), base)
    # Malformed container body: same canonical error as the host path.
    bad = blob[:-3]
    with pytest.raises(Exception):
        decompress_to_ycbcr(bad)


@pytest.mark.parametrize("value,mode", [
    ("device", "device"), ("DEVICE", "device"), ("host", "host"),
    ("", "host"), (None, "host"),
])
def test_scan_mode_policy(monkeypatch, value, mode):
    """The host scanner is the default; only JPEG_TPU_SCAN=device selects
    the device scan."""
    if value is None:
        monkeypatch.delenv("JPEG_TPU_SCAN", raising=False)
    else:
        monkeypatch.setenv("JPEG_TPU_SCAN", value)
    assert DS.scan_mode() == mode


def test_foreign_decode_deferred_through_decompress_many(monkeypatch):
    """The foreign path returns a deferred resolver (ok-flag sync moved to
    pull time); decompress_many must resolve it in its puller and produce
    images identical to the host-scan path, in order."""
    from jpeg_tpu import (Configuration, QuantizationMethod, compress_ycbcr,
                          decompress_many)
    rng = np.random.default_rng(8)
    cfg = Configuration(width=40, height=24, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    imgs = [rng.integers(0, 256, (24, 40, 3), np.uint8) for _ in range(3)]
    blobs = [compress_ycbcr(im, cfg) for im in imgs]
    base = decompress_many(blobs)
    monkeypatch.setenv("JPEG_TPU_SCAN", "device")
    got = decompress_many(blobs)
    for g, b in zip(got, base):
        assert np.array_equal(g, b)


@pytest.mark.parametrize("entry", ["decompress_to_ycbcr", "decompress_many",
                                   "scan_offsets"])
def test_failed_device_scan_on_a_valid_stream_fails_loudly(monkeypatch,
                                                           entry):
    """An ok flag that fails on a stream the host scanner accepts means the
    device scan is broken: it raises, and no host-scan decode stands in."""
    import jax.numpy as jnp
    from jpeg_tpu import (Configuration, QuantizationMethod, api,
                          compress_ycbcr, decompress_many,
                          decompress_to_ycbcr)
    real_fn = api._decode3_foreign_fn
    real_scan = DS.scan_offsets_device

    def broken_fn(key, dt):
        f = real_fn(key, dt)
        return lambda s, e: (f(s, e)[0], jnp.bool_(False))

    monkeypatch.setattr(api, "_decode3_foreign_fn", broken_fn)
    monkeypatch.setattr(DS, "scan_offsets_device",
                        lambda *a: (real_scan(*a)[0], False))
    monkeypatch.setenv("JPEG_TPU_SCAN", "device")
    rng = np.random.default_rng(9)
    cfg = Configuration(width=40, height=24, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    blob = compress_ycbcr(rng.integers(0, 256, (24, 40, 3), np.uint8), cfg)
    data = NC.encode_levels(_rand_levels(rng, 12, 64))
    run = {"decompress_to_ycbcr": lambda: decompress_to_ycbcr(blob),
           "decompress_many": lambda: decompress_many([blob, blob]),
           "scan_offsets": lambda: entropy.scan_offsets(data, 12, 64)}[entry]
    with pytest.raises(RuntimeError, match="device boundary scan"):
        run()
    # a malformed stream still gets the host scanner's canonical error
    with pytest.raises(BadStreamError):
        entropy.scan_offsets(data[:-1], 12, 64)

