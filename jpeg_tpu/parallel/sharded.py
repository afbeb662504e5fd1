"""Sharded encode/decode: batch data-parallelism and row-band tiling.

The reference processes one band of one image at a time in pure Python
(reference: pipeline/__init__.py:102-110).  Here the whole coefficient path
(pad -> subsample -> DCT+zigzag matmul -> quantize) runs as ONE jitted
program over a :class:`jax.sharding.Mesh`:

* ``data`` axis: a batch of images/bands, embarrassingly parallel.
* ``band`` axis: image rows.  DCT blocks never couple across rows, so GSPMD
  needs at most an edge-halo exchange at pad seams; everything else is local.

Entropy coding, on the host or the device as the placement policy says
(utils/device.py), is *seam-parallel*: every block's bitstream is
byte-aligned (reference:
rle_byte_stream.py:54-56), so per-row-band streams encoded independently
concatenate into exactly the single-stream bytes.  That concatenation is the
distributed "bitstream stitch": on a multi-host slice each host encodes its
local block rows and an all-gather of byte lengths fixes the offsets.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .. import container, entropy
from ..config import Configuration
from ..container import CompressedData
from ..ops import band as band_ops
from ..utils.device import pull_prefix
from . import mesh as mesh_lib
from . import stats

_BATCH_FNS: Dict[Tuple, object] = {}
_PLANE_FNS: Dict[Tuple, object] = {}


def _batch_encode_fn(key: Tuple, dtype_name: str, mesh, shape: Tuple,
                     with_stats: bool = True):
    """Jitted (B, H, W) -> ((B, N, L) levels[, total payload bytes]).

    ``with_stats=False`` skips the size-geometry pass + cross-mesh
    all-reduce for callers that only need the levels."""
    cache_key = (key, dtype_name, mesh, shape, with_stats)
    fn = _BATCH_FNS.get(cache_key)
    if fn is None:
        encode_one = band_ops.make_encode_batch(key, dtype_name)

        def step(bands):
            levels = encode_one(bands)
            if not with_stats:
                return levels
            # Global reduction over all shards -> XLA all-reduce on the mesh.
            return levels, stats.total_bytes(levels)

        h, w, bs, d, transform, qname, qparams = key
        n_blocks = Configuration(width=w, height=h, block_size=bs,
                                 dct_size=d).num_blocks
        lv_sh = mesh_lib.levels_sharding(mesh, (shape[0], n_blocks, d * d))
        out_sh = (lv_sh, mesh_lib.replicated(mesh)) if with_stats else lv_sh
        fn = jax.jit(step, in_shardings=mesh_lib.batch_sharding(mesh, shape),
                     out_shardings=out_sh)
        _BATCH_FNS[cache_key] = fn
    return fn


def _padded_blocks(n_blocks: int, n_dev: int) -> int:
    """Block count padded up to a multiple of the device count."""
    return -(-n_blocks // n_dev) * n_dev


def _plane_encode_fn(key: Tuple, dtype_name: str, mesh, shape: Tuple):
    """Jitted (H, W) -> (N_pad, L) levels with rows sharded over all devices.

    The block count is padded with all-zero blocks to a multiple of the
    device count, so the output really splits into one contiguous block
    range per device (an indivisible count would leave the whole tensor on
    every device); callers drop the rows past ``num_blocks``."""
    cache_key = (key, dtype_name, mesh, shape)
    fn = _PLANE_FNS.get(cache_key)
    if fn is None:
        h, w, bs, d, transform, qname, qparams = key
        cfg = Configuration(width=w, height=h, block_size=bs, dct_size=d,
                            transform=transform)
        encode_one = band_ops.make_encode(key, dtype_name)
        n_pad = _padded_blocks(cfg.num_blocks, mesh.devices.size)

        def step(plane):
            levels = encode_one(plane)
            return jnp.pad(levels, ((0, n_pad - levels.shape[0]), (0, 0)))

        in_sh = mesh_lib.plane_sharding(mesh, shape)
        out_sh = mesh_lib.plane_sharding(mesh, (n_pad, d * d))
        fn = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)
        _PLANE_FNS[cache_key] = fn
    return fn


def encode_batch_levels(bands, config: Configuration, mesh,
                        dtype=None) -> Tuple[np.ndarray, int]:
    """Batch-of-bands coefficient path on the mesh.

    Args:
      bands: (B, H, W) integer array of same-size image bands.
    Returns:
      ((B, num_blocks, L) int32 levels, exact total payload bytes).
    """
    bands = jnp.asarray(bands)
    band_ops.check_band_shape(bands[0], config)
    dt = np.dtype(dtype if dtype is not None else band_ops.default_dtype())
    fn = _batch_encode_fn(band_ops.config_key(config), dt.name, mesh,
                          tuple(bands.shape))
    levels, nbytes = fn(bands)
    return np.asarray(levels), int(nbytes)


def stitch_streams(parts: Sequence[bytes]) -> bytes:
    """Concatenate per-shard byte-aligned streams into the canonical stream."""
    return b"".join(parts)


def _encode_levels_parts(levels: np.ndarray, n_parts: int,
                         rows_per_part: int) -> bytes:
    """Entropy-encode (N, L) levels as row-band parts in parallel threads.

    ``levels`` rows are blocks in row-major block order; a part is a
    contiguous run of whole block-rows, so each part's stream starts
    byte-aligned and the concatenation is bit-identical to one-shot encode.
    """
    n_blocks = levels.shape[0]
    bounds = [min(i * rows_per_part, n_blocks) for i in range(n_parts + 1)]
    chunks = [levels[bounds[i]:bounds[i + 1]] for i in range(n_parts)]
    chunks = [c for c in chunks if c.shape[0]]
    if len(chunks) <= 1:
        return entropy.encode_levels(levels)
    with ThreadPoolExecutor(max_workers=len(chunks)) as pool:
        parts = list(pool.map(entropy.encode_levels, chunks))
    return stitch_streams(parts)


def compress_plane(plane, config: Configuration, mesh, dtype=None,
                   device_entropy: Optional[bool] = None) -> bytes:
    """Row-band-tiled single-plane compress; bytes == single-device bytes.

    The coefficient path runs with block rows sharded over every device.
    Entropy follows the placement policy (utils/device.py) unless
    ``device_entropy`` overrides it.  On the device, each device assembles
    the bitstream of its own block range under ``shard_map`` and the host
    only pulls each shard's used prefix; on the host, the levels come back
    and row-band parts encode on threads.  Byte-aligned blocks make either
    concatenation bit-identical to the serial stream (SURVEY.md §2b).
    """
    plane = jnp.asarray(plane)
    band_ops.check_band_shape(plane, config)
    if device_entropy is None:
        from ..utils.device import device_entropy_default
        device_entropy = device_entropy_default()
    dt = np.dtype(dtype if dtype is not None else band_ops.default_dtype())
    fn = _plane_encode_fn(band_ops.config_key(config), dt.name, mesh,
                          tuple(plane.shape))
    levels = fn(plane)                                   # (N_pad, L) device
    n_shards = mesh.devices.size
    n_blocks = config.num_blocks
    if not device_entropy:
        rows_per_shard = -(-config.blocks_high // n_shards)
        return _encode_levels_parts(np.asarray(levels)[:n_blocks], n_shards,
                                    rows_per_shard * config.blocks_wide)

    buf, blk_bytes, mx = _plane_entropy_fn(mesh, levels.shape)(levels)
    _check_amp(int(mx))
    blk_bytes = np.asarray(blk_bytes)
    m = levels.shape[0] // n_shards
    # The padding blocks are the tail of the last shards' ranges, so their
    # EOB bytes sit after the real blocks' bytes: count only real blocks.
    used = [int(blk_bytes[s * m:min((s + 1) * m, n_blocks)].sum())
            for s in range(n_shards)]
    # ONE device->host transfer for all shards (row-band shards are
    # balanced, so pulling every row to the max used length overfetches
    # little), instead of a blocking pull per shard.
    from ..utils.device import pow2_cap
    cap = min(pow2_cap(max(used, default=1)), buf.shape[1])
    host = np.asarray(buf[:, :cap])
    return stitch_streams([host[s, :used[s]].tobytes()
                           for s in range(n_shards)])


def _plane_entropy_fn(mesh, shape: Tuple):
    """Jitted per-device entropy encode of (N_pad, L) row-sharded levels
    -> (bufs (S, worst) u8, per-block bytes (N_pad,), max |level|)."""
    from functools import partial
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from ..entropy import device_codec as DC

    flat = Mesh(mesh.devices.reshape(-1), (mesh_lib.BAND_AXIS,))
    cache_key = ("shard_entropy", flat, shape)
    fn = _PLANE_FNS.get(cache_key)
    if fn is None:
        @partial(shard_map, mesh=flat, in_specs=P(mesh_lib.BAND_AXIS, None),
                 out_specs=(P(mesh_lib.BAND_AXIS, None),
                            P(mesh_lib.BAND_AXIS), P()))
        def shard_encode(local_levels):
            buf, blk_bytes = DC.encode_stream(local_levels)
            mx = jax.lax.pmax(jnp.max(jnp.abs(local_levels)),
                              mesh_lib.BAND_AXIS)
            return buf[None, :], blk_bytes, mx.astype(jnp.int32)
        fn = jax.jit(shard_encode)
        _PLANE_FNS[cache_key] = fn
    return fn


def decompress_plane(data: bytes, config: Configuration, mesh,
                     dtype=None, device_entropy: Optional[bool] = None
                     ) -> np.ndarray:
    """Row-band-tiled decode of ONE band stream — the dual of
    :func:`compress_plane` (reference dual: the descending
    ``decompress_band`` pipeline, pipeline/__init__.py:79-88).

    Entropy follows the placement policy unless ``device_entropy``
    overrides it.  On the device (:func:`_decode_plane_device`) the host
    performs only the serial O(bytes) boundary scan; otherwise the host
    C++ codec parses and the IDCT path runs sharded.  Either way block rows
    are split over the flattened mesh, and the result is bit-equal to
    ``api.decompress_band`` (same decode operator, same codec).
    """
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    nb, L = config.num_blocks, config.dct_size ** 2
    dt = np.dtype(dtype if dtype is not None else band_ops.default_dtype())
    if device_entropy is None:
        from ..entropy import device_codec as DC
        from ..utils.device import device_entropy_default, pow2_cap
        device_entropy = (device_entropy_default()
                          and pow2_cap(len(data) + 1) * 8 < DC._CAP_BITS)
    if device_entropy:
        return np.asarray(_decode_plane_device(data, config, mesh, dt))

    # Host entropy decode (C++/NumPy), then the sharded IDCT path.
    key = band_ops.config_key(config)
    flat = Mesh(mesh.devices.reshape(-1), (mesh_lib.BAND_AXIS,))
    n_pad = _padded_blocks(nb, flat.devices.size)
    levels = np.zeros((n_pad, L), np.int32)
    levels[:nb] = entropy.decode_levels(bytes(data), nb, L)
    cache_key = ("dec_plane", key, dt.name, flat)
    fn = _PLANE_FNS.get(cache_key)
    if fn is None:
        decode_one = band_ops.make_decode(key, dt.name)
        fn = jax.jit(lambda lv: decode_one(lv[:nb]),
                     in_shardings=NamedSharding(
                         flat, P(mesh_lib.BAND_AXIS, None)),
                     out_shardings=_plane_out_sharding(config, flat))
        _PLANE_FNS[cache_key] = fn
    return np.asarray(fn(levels))


def _plane_out_sharding(config: Configuration, flat):
    from jax.sharding import NamedSharding, PartitionSpec as P
    return NamedSharding(flat, mesh_lib.fit_spec(
        (config.height, config.width), flat, P(mesh_lib.BAND_AXIS, None)))


def _decode_plane_device(data: bytes, config: Configuration, mesh, dt):
    """Device bit parse + decode of one band stream -> (H, W) device plane,
    rows sharded over the flattened mesh.

    The host runs the O(bytes) boundary scan.  The stream replicates to
    every device (compressed bytes are small) and each device parses only
    its own contiguous block range under ``shard_map``.  The block count is
    padded to a multiple of the device count with starts at a trailing
    zero byte (an immediate EOB, i.e. an all-zero block), dropped before
    the IDCT."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from ..entropy import device_codec as DC
    from ..utils.device import pow2_cap

    nb, L = config.num_blocks, config.dct_size ** 2
    key = band_ops.config_key(config)
    flat = Mesh(mesh.devices.reshape(-1), (mesh_lib.BAND_AXIS,))
    n_pad = _padded_blocks(nb, flat.devices.size)
    pad = pow2_cap(len(data) + 1)
    arr = np.zeros(pad, np.uint8)
    arr[:len(data)] = np.frombuffer(data, np.uint8)
    rep = NamedSharding(flat, P())
    rows = NamedSharding(flat, P(mesh_lib.BAND_AXIS))
    # Start the stream upload before the serial boundary scan: device_put
    # is async, so the h2d transfer rides under the O(bytes) host scan.
    arr_dev = jax.device_put(arr, rep)
    starts = np.full(n_pad, len(data), np.int32)
    starts[:nb] = entropy.scan_offsets(data, nb, L)    # validates the stream
    cache_key = ("dec_plane_stream", key, dt.name, flat, pad)
    fn = _PLANE_FNS.get(cache_key)
    if fn is None:
        decode_one = band_ops.make_decode(key, dt.name)

        def parse_local(stream, local_starts):
            return DC.decode_stream(stream, local_starts, L)

        def step(stream, starts_arr):
            levels = jax.shard_map(
                parse_local, mesh=flat,
                in_specs=(P(), P(mesh_lib.BAND_AXIS)),
                out_specs=P(mesh_lib.BAND_AXIS, None))(stream, starts_arr)
            return decode_one(levels[:nb])

        fn = jax.jit(step, in_shardings=(rep, rows),
                     out_shardings=_plane_out_sharding(config, flat))
        _PLANE_FNS[cache_key] = fn
    return fn(arr_dev, starts)


def _batch_stream_fn(key: Tuple, dtype_name: str, mesh, shape: Tuple):
    """Jitted (B, H, W) -> (stream bytes, per-band byte counts, max level)."""
    cache_key = ("stream", key, dtype_name, mesh, shape)
    fn = _BATCH_FNS.get(cache_key)
    if fn is None:
        from ..entropy import device_codec as DC
        encode_one = band_ops.make_encode_batch(key, dtype_name)

        def step(bands):
            levels = encode_one(bands)          # (B, N, L)
            flat = levels.reshape(-1, levels.shape[-1])
            return DC.encode_bands_stream(flat, bands.shape[0])

        fn = jax.jit(step, in_shardings=mesh_lib.batch_sharding(mesh, shape))
        _BATCH_FNS[cache_key] = fn
    return fn


def _batch_stream_chunked_fn(key: Tuple, dtype_name: str, mesh, shape: Tuple,
                             chunk_blocks: int):
    """Jitted (B, H, W) -> (chunk bufs, per-block bytes, band bytes, max)
    for batches whose worst-case output exceeds int32 bit positions."""
    cache_key = ("stream_chunked", key, dtype_name, mesh, shape, chunk_blocks)
    fn = _BATCH_FNS.get(cache_key)
    if fn is None:
        from ..entropy import device_codec as DC
        encode_one = band_ops.make_encode_batch(key, dtype_name)

        def step(bands):
            levels = encode_one(bands)          # (B, N, L)
            flat = levels.reshape(-1, levels.shape[-1])
            bufs, blk_bytes = DC.encode_stream_chunks(flat)
            band_bytes = jnp.sum(blk_bytes.reshape(bands.shape[0], -1),
                                 axis=-1)
            mx = jnp.max(jnp.abs(flat)).astype(jnp.int32)
            return bufs, blk_bytes, band_bytes, mx

        fn = jax.jit(step, in_shardings=mesh_lib.batch_sharding(mesh, shape))
        _BATCH_FNS[cache_key] = fn
    return fn


def _check_amp(mx: int) -> None:
    from ..config import BadRleCodeError
    from ..entropy import MAX_AMP
    if mx > MAX_AMP:
        raise BadRleCodeError(
            f"amplitude {mx} exceeds the representable {MAX_AMP}")


def compress_batch(images, config: Configuration, mesh,
                   dtype=None, device_entropy: Optional[bool] = None
                   ) -> List[bytes]:
    """(B, H, W, 3) uint8 YCbCr batch -> list of B container blobs.

    The coefficient path for all B*3 bands runs as one sharded program.
    Entropy: on device (where the entropy policy places it) the whole batch's
    bitstream is assembled in the same program and only the compressed
    bytes come back; otherwise per-band host encodes run on a thread pool
    (the C++ codec releases the GIL during the ctypes call).
    """
    images = np.asarray(images)
    if images.ndim != 4 or images.shape[3] != 3:
        raise ValueError(f"expected (B, H, W, 3) batch, got {images.shape}")
    b = images.shape[0]
    bands = images.transpose(0, 3, 1, 2).reshape(
        b * 3, images.shape[1], images.shape[2])
    if device_entropy is None:
        from ..utils.device import device_entropy_default
        device_entropy = device_entropy_default()

    dt = np.dtype(dtype if dtype is not None else band_ops.default_dtype())
    key = band_ops.config_key(config)
    if device_entropy:
        from ..entropy import device_codec as DC
        n_total = b * 3 * config.num_blocks
        m = DC.max_chunk_blocks(config.dct_size ** 2)
        if n_total <= m:
            fn = _batch_stream_fn(key, dt.name, mesh, tuple(bands.shape))
            stream, band_bytes, mx = fn(jnp.asarray(bands))
            _check_amp(int(mx))
            buf = pull_prefix(stream, int(np.asarray(band_bytes).sum()))
        else:
            # Past the int32 bit-position ceiling the encoder self-chunks;
            # byte-aligned blocks make the chunk concatenation exact.
            fn = _batch_stream_chunked_fn(key, dt.name, mesh,
                                          tuple(bands.shape), m)
            bufs, blk_bytes, band_bytes, mx = fn(jnp.asarray(bands))
            _check_amp(int(mx))
            buf = DC.assemble_chunks(bufs, blk_bytes, m)
        bb = np.asarray(band_bytes).astype(np.int64)
        offs = np.concatenate([[0], np.cumsum(bb)])
        streams = [buf[offs[i]:offs[i + 1]] for i in range(3 * b)]
    else:
        fn = _batch_encode_fn(key, dt.name, mesh, tuple(bands.shape),
                              with_stats=False)
        levels = np.asarray(fn(jnp.asarray(bands)))
        with ThreadPoolExecutor(max_workers=min(16, max(1, b * 3))) as pool:
            streams = list(pool.map(entropy.encode_levels, list(levels)))
    out = []
    for i in range(b):
        data = CompressedData(streams[3 * i], streams[3 * i + 1],
                              streams[3 * i + 2])
        out.append(container.generate_data(config, data))
    return out


def decompress_batch(blobs: Sequence[bytes], mesh, dtype=None,
                     device_entropy: Optional[bool] = None) -> np.ndarray:
    """List of container blobs (same config) -> (B, H, W, 3) uint8 batch.

    With device entropy (where the entropy policy places it), the host performs only
    the per-band boundary scans; the concatenated streams upload once and
    all bit parsing + IDCT runs in a single jitted program.
    """
    configs_and_data = [container.read_data(b) for b in blobs]
    config = configs_and_data[0][0]
    L = config.dct_size ** 2
    nb = config.num_blocks
    flat_streams = []
    for cfg, data in configs_and_data:
        if band_ops.config_key(cfg) != band_ops.config_key(config):
            raise ValueError("decompress_batch requires a homogeneous batch")
        flat_streams.extend([data.y, data.cb, data.cr])

    if device_entropy is None:
        from ..utils.device import device_entropy_default, pow2_cap
        total = sum(len(s) for s in flat_streams)
        from ..entropy import device_codec as DC
        # Conservative: the sharded upload only needs each SLICE under the
        # codec ceiling (DC._CAP_BITS), but slice sizes aren't known until
        # after the boundary scan; total is always an upper bound.
        device_entropy = (device_entropy_default()
                          and pow2_cap(total) * 8 < DC._CAP_BITS)
    if device_entropy:
        return np.asarray(_decompress_batch_device(
            flat_streams, config, mesh, len(blobs), dtype)).transpose(
                0, 2, 3, 1)

    with ThreadPoolExecutor(max_workers=min(16, len(flat_streams))) as pool:
        levels = list(pool.map(
            lambda s: entropy.decode_levels(s, nb, L), flat_streams))
    levels = np.stack(levels)  # (B*3, N, L)

    dt = np.dtype(dtype if dtype is not None else band_ops.default_dtype())
    key = band_ops.config_key(config)
    cache_key = ("dec", key, dt.name, mesh, levels.shape)
    fn = _BATCH_FNS.get(cache_key)
    if fn is None:
        decode_one = band_ops.make_decode(key, dt.name)
        fn = jax.jit(jax.vmap(decode_one),
                     in_shardings=mesh_lib.levels_sharding(
                         mesh, levels.shape))
        _BATCH_FNS[cache_key] = fn
    planes = np.asarray(fn(jnp.asarray(levels)))  # (B*3, H, W)
    b = len(blobs)
    return planes.reshape(b, 3, config.height, config.width).transpose(
        0, 2, 3, 1).astype(np.uint8)


def _shard_stream_slices(flat_streams: Sequence[bytes],
                         scans: Sequence[np.ndarray],
                         ndev: int) -> Tuple[np.ndarray, np.ndarray]:
    """Split a batch of byte-aligned band streams into per-device slices.

    Every block's bitstream is byte-aligned (reference rle_byte_stream.py:
    54-56) and its start byte is host-known from the boundary scans, so the
    flat block range splits CONTIGUOUSLY across devices: device k gets
    blocks [k*Nd, (k+1)*Nd) and only the bytes those blocks occupy — the
    decode dual of the encode bitstream stitch.  Without this, the whole
    concatenated batch stream would replicate to every device (8x HBM for
    a multi-GB batch on a real slice).

    Returns ``(slices (ndev, sw) uint8, local_starts (ndev, Nd) int32)``
    where ``sw`` is the pow2-bucketed longest slice.  The flat block count
    pads to a multiple of ndev with dummy blocks pointing at a trailing
    zero byte (a 0x00 stream decodes as immediate EOB -> an all-zero
    block); callers drop the padded tail.  Slice padding bytes are zero.
    """
    from ..utils.device import pow2_cap

    # Global block start offsets (int64 on the host: only shard-LOCAL
    # offsets ever reach the device, so batches past int32 total bytes
    # stay decodable as long as each shard's slice fits).
    starts, off = [], 0
    for s, sc in zip(flat_streams, scans):
        starts.append(sc.astype(np.int64) + off)
        off += len(s)
    gstarts = np.concatenate(starts)
    total = off
    n = gstarts.shape[0]
    n_pad = -(-n // ndev) * ndev
    nd = n_pad // ndev
    # Block ends = next block's start; last real block ends at the stream
    # end; dummy blocks read the appended zero byte.
    ends = np.concatenate([gstarts[1:], [total]])
    if n_pad != n:
        gstarts = np.concatenate(
            [gstarts, np.full(n_pad - n, total, np.int64)])
        ends = np.concatenate([ends, np.full(n_pad - n, total + 1, np.int64)])
    buf = b"".join(flat_streams) + b"\x00"
    lo = gstarts[0::nd]                           # slice base per device
    hi = ends[nd - 1::nd]                         # slice end per device
    sw = pow2_cap(int((hi - lo).max()))
    slices = np.zeros((ndev, sw), np.uint8)
    view = np.frombuffer(buf, np.uint8)
    for k in range(ndev):
        slices[k, :hi[k] - lo[k]] = view[lo[k]:hi[k]]
    local = (gstarts.reshape(ndev, nd) - lo[:, None]).astype(np.int32)
    return slices, local


def _decompress_batch_device(flat_streams: List[bytes],
                             config: Configuration, mesh, b: int,
                             dtype=None) -> np.ndarray:
    """Device bit-parse + decode for a homogeneous batch of band streams
    -> (B, 3, H, W) uint8 device planes, batch over ``data`` and rows over
    ``band``.

    The bit parse runs under ``shard_map`` over the flattened mesh with
    each device holding ONLY its contiguous slice of the batch stream
    (:func:`_shard_stream_slices`); the parsed levels then reshard to the
    (data, band) layout for the IDCT stage — levels are ~4x the pixel
    volume, far cheaper to move between devices than replicating the
    stream.
    """
    from ..entropy import device_codec as DC

    nb, L = config.num_blocks, config.dct_size ** 2
    with ThreadPoolExecutor(max_workers=min(16, len(flat_streams))) as pool:
        scans = list(pool.map(
            lambda s: entropy.scan_offsets(s, nb, L), flat_streams))
    ndev = int(mesh.devices.size)
    slices, local_starts = _shard_stream_slices(flat_streams, scans, ndev)
    n = b * 3 * nb

    dt = np.dtype(dtype if dtype is not None else band_ops.default_dtype())
    key = band_ops.config_key(config)
    cache_key = ("dec_stream", key, dt.name, mesh, slices.shape,
                 local_starts.shape, b)
    fn = _BATCH_FNS.get(cache_key)
    if fn is None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        decode_one = band_ops.make_decode(key, dt.name)
        # One device per row of `slices`: shard dim 0 over BOTH mesh axes
        # jointly (flat device order == mesh.devices.reshape(-1), the order
        # _shard_stream_slices assigned block ranges in).
        both = (mesh_lib.DATA_AXIS, mesh_lib.BAND_AXIS)
        lv_sh = NamedSharding(mesh, mesh_lib.fit_spec(
            (b, 3, nb, L), mesh,
            P(mesh_lib.DATA_AXIS, None, mesh_lib.BAND_AXIS, None)))
        in_sh = NamedSharding(mesh, P(both, None))

        def parse_local(sl, st):
            return DC.decode_stream(sl[0], st[0], L)[None]

        def step(sl, st):
            lv = jax.shard_map(parse_local, mesh=mesh,
                               in_specs=(P(both, None), P(both, None)),
                               out_specs=P(both, None, None))(sl, st)
            levels = jax.lax.with_sharding_constraint(
                lv.reshape(-1, L)[:n].reshape(b, 3, nb, L), lv_sh)
            planes = jax.vmap(jax.vmap(decode_one))(levels)
            return planes.astype(jnp.uint8)          # (B, 3, H, W)

        out_sh = NamedSharding(mesh, mesh_lib.fit_spec(
            (b, 3, config.height, config.width), mesh,
            P(mesh_lib.DATA_AXIS, None, mesh_lib.BAND_AXIS, None)))
        fn = jax.jit(step, in_shardings=(in_sh, in_sh), out_shardings=out_sh)
        _BATCH_FNS[cache_key] = fn
    return fn(slices, local_starts)
