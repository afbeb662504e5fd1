"""Public codec API: band-level and image-level compress/decompress.

Mirrors the reference surface (pipeline/__init__.py:71-124): ``compress_band``
/ ``decompress_band`` operate on single planes; :class:`Jpeg` splits an image
into Y/Cb/Cr bands, compresses each independently with the same config, and
packs the container.  PIL appears only at the image edges; the core works on
arrays.
"""
from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
import jax
import jax.numpy as jnp
import numpy as np

from . import container, entropy
from .config import BadRleCodeError, Configuration, QuantizationMethod  # re-export
from .container import CompressedData
from .ops import band as _band
from .ops.band import decode_band_levels, encode_band_levels


def compress_band(a, config: Configuration, dtype=None) -> bytes:
    """(H, W) integer band -> entropy-coded bytestream."""
    levels = encode_band_levels(a, config, dtype=dtype)
    return entropy.encode_levels(np.asarray(levels))


def decompress_band(data: bytes, config: Configuration, dtype=None) -> np.ndarray:
    """Band bytestream -> (H, W) int reconstruction."""
    levels = entropy.decode_levels(bytes(data), config.num_blocks,
                                   config.dct_size ** 2)
    return np.asarray(decode_band_levels(levels, config, dtype=dtype))


@functools.lru_cache(maxsize=None)
def _encode3_fn(key, dtype_name: str):
    """One jitted call transforming all 3 bands: (3, H, W) -> (3, N, L) i16.

    A single device launch + a single device->host pull per image instead of
    three.  Levels are shipped as int16 (any representable stream has
    |amp| <= 16383, reference util.py:162-174) with a device-computed max
    |level| so the host can reject unrepresentable streams before the
    narrowing loses anything.
    """
    enc = _band.make_encode_batch(key, dtype_name)

    def f(bands):
        levels = enc(bands)
        mx = jnp.max(jnp.abs(levels))
        return levels.astype(jnp.int16), mx.astype(jnp.int32)

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _decode3_fn(key, dtype_name: str):
    """(3, N, L) int16 levels -> (3, H, W) uint8 planes (one launch)."""
    dec = _band.make_decode(key, dtype_name)

    def f(levels16):
        planes = jax.vmap(dec)(levels16.astype(jnp.int32))
        return planes.astype(jnp.uint8)   # already clamped to [0, 255]

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _encode3_stream_fn(key, dtype_name: str):
    """Fully-device encode: (3, H, W) -> (stream bytes, band lengths, max).

    The entropy bitstream is assembled on device (entropy/device_codec.py),
    so the only device->host traffic is the compressed bytes themselves —
    typically 5-40x smaller than the coefficient levels.
    """
    from .entropy import device_codec as DC
    enc = _band.make_encode_batch(key, dtype_name)

    def f(bands):
        levels = enc(bands)                            # (3, N, L)
        flat = levels.reshape(-1, levels.shape[-1])
        return DC.encode_bands_stream(flat, 3)

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _encode3_stream_chunked_fn(key, dtype_name: str, chunk_blocks: int):
    """Device encode for batches past the int32 bit-position ceiling:
    (3, H, W) -> (chunk buffers, per-block bytes, band lengths, max).

    ``chunk_blocks`` keys the cache so a changed cap retraces."""
    from .entropy import device_codec as DC
    enc = _band.make_encode_batch(key, dtype_name)

    def f(bands):
        levels = enc(bands)                            # (3, N, L)
        flat = levels.reshape(-1, levels.shape[-1])
        bufs, blk_bytes = DC.encode_stream_chunks(flat)
        band_bytes = jnp.sum(blk_bytes.reshape(3, -1), axis=-1)
        mx = jnp.max(jnp.abs(flat)).astype(jnp.int32)
        return bufs, blk_bytes, band_bytes, mx

    return jax.jit(f)


from .utils.device import pull_prefix as _pull_prefix  # shared helper


@functools.lru_cache(maxsize=None)
def _decode3_stream_fn(key, dtype_name: str):
    """Fully-device decode: (stream bytes, block starts) -> (3, H, W) u8.

    The host does only the serial O(bytes) boundary scan; bit parsing, IDCT
    and clamping all run in one jitted program (entropy/device_codec.py)."""
    from .entropy import device_codec as DC
    L = key[3] * key[3]
    dec = _band.make_decode(key, dtype_name)

    def f(stream, starts):
        levels = DC.decode_stream(stream, starts, L)    # (3*nb, L)
        planes = jax.vmap(dec)(levels.reshape(3, -1, L))
        return planes.astype(jnp.uint8)

    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _decode3_foreign_fn(key, dtype_name: str):
    """ONE-dispatch host-free decode of a foreign stream: (padded stream
    bytes, band end offsets) -> ((3, H, W) u8 planes, ok).

    Scan + bit parse + dequant + IDCT + clamp in a single program — no
    host boundary scan at all (replacing the reference's serial parse,
    rle_byte_stream.py:60-88).  ok False means the planes are garbage —
    the host scanner then reruns to raise its canonical error (or, for a
    stream it accepts, an error naming the device scan)."""
    from .entropy import device_codec as DC
    from .entropy import device_scan as DS
    h, w, bs, d, transform, qname, qparams = key
    cfg = Configuration(width=w, height=h, block_size=bs, dct_size=d,
                        transform=transform,
                        quantization=QuantizationMethod(qname, **dict(qparams)))
    L = d * d
    nb = cfg.num_blocks
    dec = _band.make_decode(key, dtype_name)

    def f(stream, ends):
        starts, ok = DS.scan_bands_starts(stream, ends, nb, L)
        levels = DC.decode_stream(stream, starts, L)
        planes = jax.vmap(dec)(levels.reshape(3, nb, L))
        return planes.astype(jnp.uint8), ok

    return jax.jit(f)


def _foreign_decode_lazy(config: Configuration, streams, dt):
    """Dispatch the fused scan+decode WITHOUT syncing; return a zero-arg
    resolver that checks the in-program ok flag at pull time and, when it
    fails, raises (device_scan.raise_rejected) instead of decoding another
    way.  Deferring the ok sync keeps the main thread free to dispatch the
    next image — decompress_many's documented overlap."""
    from .entropy.device_scan import raise_rejected
    from .utils.device import quarter_cap
    buf = b"".join(streams)
    # Quarter-octave padding: every padded byte is a walker (device_scan).
    pad = quarter_cap(len(buf))
    arr = np.zeros(pad, np.uint8)
    arr[:len(buf)] = np.frombuffer(buf, np.uint8)
    ends = jnp.asarray(np.cumsum([len(s) for s in streams]).astype(np.int32))
    fn = _decode3_foreign_fn(_band.config_key(config), dt.name)
    planes, ok = fn(jax.device_put(arr), ends)       # async dispatch

    def resolve():
        if not bool(ok):                             # syncs THIS dispatch
            raise_rejected(streams, config.num_blocks, config.dct_size ** 2)
        return planes

    return resolve


def _dtype(dtype) -> np.dtype:
    return np.dtype(dtype if dtype is not None else _band.default_dtype())


def _use_device_entropy() -> bool:
    from .utils.device import device_entropy_default
    return device_entropy_default()


def _start_compress(ycbcr: np.ndarray, config: Configuration, dt):
    """Dispatch the device half of an image encode WITHOUT blocking.

    Returns an opaque state consumed by :func:`_finish_compress`.  JAX
    dispatch is asynchronous, so after this returns the upload + on-device
    compute proceed while the host does other work — the hook that lets
    :func:`compress_many` overlap image i's result pull with image i+1's
    transfer and compute.
    """
    ycbcr = np.asarray(ycbcr)
    if ycbcr.ndim != 3 or ycbcr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) YCbCr array, got {ycbcr.shape}")
    _band.check_band_shape(ycbcr[:, :, 0], config)
    planes = np.ascontiguousarray(ycbcr.transpose(2, 0, 1))
    from .entropy import device_codec as DC
    L = config.dct_size ** 2
    key = _band.config_key(config)
    if _use_device_entropy():
        m = DC.max_chunk_blocks(L)
        if 3 * config.num_blocks <= m:
            return ("dev", *_encode3_stream_fn(key, dt.name)(planes))
        # Worst-case output exceeds int32 bit positions: the encoder
        # self-chunks on device; byte-aligned blocks concatenate exactly.
        fn = _encode3_stream_chunked_fn(key, dt.name, m)
        return ("dev_chunked", m, *fn(planes))
    return ("host", *_encode3_fn(key, dt.name)(planes))


def _check_mx(mx) -> None:
    if int(mx) > entropy.MAX_AMP:
        raise BadRleCodeError(
            f"amplitude {int(mx)} exceeds the representable "
            f"{entropy.MAX_AMP}")


def _finish_compress(state, config: Configuration) -> bytes:
    """Block on a :func:`_start_compress` state and pack the container."""
    from .entropy import device_codec as DC
    kind = state[0]
    if kind == "dev":
        _, stream, band_bytes, mx = state
        _check_mx(mx)
        bb = [int(x) for x in np.asarray(band_bytes)]
        buf = _pull_prefix(stream, sum(bb))
        bands = [buf[sum(bb[:i]):sum(bb[:i + 1])] for i in range(3)]
    elif kind == "dev_chunked":
        _, m, bufs, blk_bytes, band_bytes, mx = state
        _check_mx(mx)
        bb = [int(x) for x in np.asarray(band_bytes)]
        buf = DC.assemble_chunks(bufs, blk_bytes, m)
        bands = [buf[sum(bb[:i]):sum(bb[:i + 1])] for i in range(3)]
    else:
        _, levels16, mx = state
        _check_mx(mx)
        levels = np.asarray(levels16)
        with ThreadPoolExecutor(max_workers=3) as pool:
            bands = list(pool.map(entropy.encode_levels, list(levels)))
    return container.generate_data(config, CompressedData(*bands))


def compress_ycbcr(ycbcr: np.ndarray, config: Configuration,
                   dtype=None) -> bytes:
    """(H, W, 3) uint8 YCbCr image -> container bytes.

    All three bands (including luma) go through the same subsample path,
    matching the reference (pipeline/__init__.py:102-110).
    """
    return _finish_compress(_start_compress(ycbcr, config, _dtype(dtype)),
                            config)


def compress_many(images, config: Configuration, dtype=None,
                  depth: int = 2) -> list:
    """Pipelined encode of an iterable of (H, W, 3) YCbCr images.

    Keeps up to ``depth`` images in flight: while image i's compressed
    bytes stream back to the host, image i+1 is already uploading and
    transforming on the device.  Results are identical to per-image
    :func:`compress_ycbcr`.
    """
    from collections import deque
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    dt = _dtype(dtype)
    states: deque = deque()
    out = []
    # The result pull (_finish_compress) blocks on a d2h transfer; run it on
    # a single worker so the main thread keeps uploading/dispatching the next
    # image while the previous one's bytes stream back.  One worker keeps
    # pulls ordered; `depth` still bounds in-flight device buffers.
    # Invariant: every deque entry except possibly the newest is a worker
    # future resolving to bytes; the newest may be a raw state.
    with ThreadPoolExecutor(max_workers=1) as puller:
        def resolve(item) -> bytes:
            if hasattr(item, "result"):
                return item.result()
            return _finish_compress(item, config)

        for img in images:
            if len(states) >= depth:
                out.append(resolve(states.popleft()))
            state = _start_compress(img, config, dt)
            if states:
                # Hand the previous image's blocking pull to the worker
                # AFTER dispatching this one's upload, so the pull overlaps
                # the new transfer + transform.
                states.append(puller.submit(_finish_compress, states.pop(),
                                            config))
            states.append(state)
        while states:
            out.append(resolve(states.popleft()))
    return out


def decompress_to_ycbcr(bytestream: bytes, dtype=None) -> np.ndarray:
    """Container bytes -> (H, W, 3) uint8 YCbCr image.

    Where the entropy policy (utils/device.py:device_entropy_default) puts
    decode on the device, the host does only the O(bytes) boundary scan (C++,
    or the pure-Python scanner when no compiler is present) and uploads the
    compressed stream itself instead of the coefficient levels.
    """
    return np.asarray(_resolve_planes(
        _start_decompress(bytestream, dtype))).transpose(1, 2, 0)


def _start_decompress(bytestream: bytes, dtype):
    """Dispatch the device half of a decode without blocking (container
    parse + boundary scan stay host-side; bit parse + IDCT dispatch async).

    May return a zero-arg CALLABLE instead of a device array (the foreign
    host-free path defers its ok-check so the dispatch never syncs here);
    callers resolve it at pull time (:func:`_resolve_planes`)."""
    config, data = container.read_data(bytestream)
    dt = _dtype(dtype)
    from .utils.device import pow2_cap
    from .entropy import device_codec as DC
    from .entropy.device_scan import scan_mode
    nb, L = config.num_blocks, config.dct_size ** 2
    streams = [data.y, data.cb, data.cr]
    total = sum(len(s) for s in streams)
    # Gate on the codec's own tunable bit-position ceiling (DC._CAP_BITS,
    # tests lower it) so admission and the decode_stream check never skew.
    if pow2_cap(total) * 8 < DC._CAP_BITS and nb > 0:
        if scan_mode() == "device":
            # Host-free path: scan + parse + IDCT in ONE dispatch
            # (_decode3_foreign_fn), returned as a deferred resolver so the
            # in-program ok flag is only synced at pull time — the main
            # thread stays free to dispatch the next image.
            return _foreign_decode_lazy(config, streams, dt)
        if _use_device_entropy():
            return _host_scan_decompress(config, streams, dt)
    with ThreadPoolExecutor(max_workers=3) as pool:
        levels = list(pool.map(
            lambda s: entropy.decode_levels(s, nb, L), streams))
    fn = _decode3_fn(_band.config_key(config), dt.name)
    return fn(np.stack(levels).astype(np.int16))


def _resolve_planes(res):
    """Resolve a :func:`_start_decompress` result: deferred foreign-path
    resolvers are called (syncing their ok flag, raising if it failed);
    device arrays pass through."""
    return res() if callable(res) else res


def _host_scan_decompress(config: Configuration, streams, dt):
    """Device-entropy decode: host boundary scan + device bit parse/IDCT
    (one dispatch); returns the un-pulled device planes."""
    from .utils.device import pow2_cap
    nb, L = config.num_blocks, config.dct_size ** 2
    buf = b"".join(streams)
    pad = pow2_cap(len(buf))
    arr = np.zeros(pad, np.uint8)
    arr[:len(buf)] = np.frombuffer(buf, np.uint8)
    # Kick the stream upload off FIRST (device_put is async), then run
    # the serial O(bytes) boundary scans while the bytes are in flight —
    # one band per thread (the C++ scanner releases the GIL), so the
    # host-side prelude and the h2d transfer overlap instead of stacking.
    arr_dev = jax.device_put(arr)
    with ThreadPoolExecutor(max_workers=3) as pool:
        scans = list(pool.map(
            lambda s: entropy.scan_offsets(s, nb, L), streams))
    offs = np.cumsum([0] + [len(s) for s in streams[:-1]])
    all_starts = np.concatenate([sc + o for sc, o in zip(scans, offs)])
    fn = _decode3_stream_fn(_band.config_key(config), dt.name)
    return fn(arr_dev, all_starts)


def decompress_to_device(bytestream: bytes, dtype=None):
    """Container bytes -> (3, H, W) uint8 planes as a DEVICE array,
    NOT pulled to the host.

    The device-resident consumer form: pipelines whose next stage runs on
    the accelerator anyway (augmentation, ML preprocessing, filters) chain
    from this array instead of round-tripping the planes through numpy.
    ``np.asarray(result)`` recovers :func:`decompress_to_ycbcr`'s planes
    (transpose to (H, W, 3) for the image convention)."""
    return _resolve_planes(_start_decompress(bytestream, dtype))


def decompress_many(blobs, dtype=None, depth: int = 2) -> list:
    """Pipelined decode of an iterable of container blobs: image i's plane
    pull overlaps image i+1's host scan + device decode.  Results are
    identical to per-image :func:`decompress_to_ycbcr`."""
    from collections import deque
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    pending: deque = deque()
    out = []

    def pull(planes):
        return np.asarray(_resolve_planes(planes)).transpose(1, 2, 0)

    # Plane pulls block on a 3*H*W d2h transfer; a single worker keeps them
    # ordered while the main thread runs the next blob's host boundary scan
    # and device dispatch under the previous blob's download.
    with ThreadPoolExecutor(max_workers=1) as puller:
        for blob in blobs:
            if len(pending) >= depth:
                out.append(pending.popleft().result())
            pending.append(puller.submit(pull, _start_decompress(blob, dtype)))
        while pending:
            out.append(pending.popleft().result())
    return out


class Jpeg:
    """Image-level codec (reference pipeline/__init__.py:98-124)."""

    def __init__(self, config: Configuration, dtype=None):
        self.config = config
        self.dtype = dtype

    def compress(self, image) -> bytes:
        """Compress a PIL image (converted to YCbCr) or (H, W, 3) array."""
        arr = _to_ycbcr_array(image)
        return compress_ycbcr(arr, self.config, dtype=self.dtype)

    @staticmethod
    def decompress(bytestream: bytes, dtype=None):
        """Decompress container bytes to a PIL YCbCr image (or an array if
        PIL is unavailable)."""
        arr = decompress_to_ycbcr(bytestream, dtype=dtype)
        try:
            from PIL import Image
        except ImportError:
            return arr
        return Image.fromarray(arr, mode="YCbCr")


def _to_ycbcr_array(image) -> np.ndarray:
    if isinstance(image, np.ndarray):
        return image
    if image.mode != "YCbCr":
        image = image.convert("YCbCr")
    return np.asarray(image)


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio between two images (dB)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))
