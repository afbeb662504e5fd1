"""Multi-host execution: jax.distributed + cross-host bitstream stitch.

The reference is strictly single-process (SURVEY.md §2b).  Across several
processes (one per host, or one per card of a host) the codec scales with
the standard JAX recipe:

* ``initialize()`` wires up the distributed runtime — a no-op for
  single-process runs.
* The coefficient path is the same global-mesh jitted program as
  :mod:`jpeg_tpu.parallel.sharded`; each host feeds its local rows via
  ``multihost_utils.host_local_array_to_global_array``.
* Entropy coding is host-local over the host's own block rows (byte-aligned
  blocks make per-host streams independently valid), then one
  ``process_allgather`` of (length, padded stream) pairs fixes the offsets
  and every host materializes the identical stitched stream.

Single-process behavior degenerates exactly to ``sharded.compress_plane``
(tested); the multi-process branches use only public collectives.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from .. import entropy
from ..config import Configuration
from ..ops import band as band_ops
from . import mesh as mesh_lib
from . import sharded


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Bring up jax.distributed.  Safe to skip for one process.

    Nothing in the environment describes the cluster, so several processes
    need ``coordinator_address`` (``host:port`` of process 0) and their
    ``process_id``.  When several processes share one host, give each its
    own card, e.g. ``local_device_ids=[k]``: a JAX process otherwise
    reserves most of the memory of every card it sees, and the next
    process on that host fails for want of it.
    """
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("several processes need coordinator_address and "
                         "process_id")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def global_mesh(data: Optional[int] = None,
                band: Optional[int] = None):
    """Mesh over every device of every process."""
    return mesh_lib.make_mesh(data=data, band=band)


def compress_plane_distributed(plane, config: Configuration,
                               mesh=None) -> bytes:
    """Row-band compress across all hosts; every host returns the full
    stitched stream (bit-identical to the serial encoder's output).

    Args:
      plane: on a single process, the full (H, W) band.  On multiple
        processes, the host-local row slice (this host's share of image
        rows, split on block-row boundaries).
    """
    nproc = jax.process_count()
    if mesh is None:
        mesh = global_mesh()

    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    # Host-local rows -> one global sharded array (no host ever holds it
    # all).  The global plane is the original image: (height, width).
    gshape = (config.height, config.width)
    flat = mesh_lib.plane_sharding(mesh, gshape)
    spec = mesh_lib.fit_spec(gshape, flat.mesh, P(mesh_lib.BAND_AXIS, None))
    if nproc > 1 and spec[0] is None:
        raise ValueError(
            f"multi-host row-band tiling needs height {config.height} "
            f"divisible by {flat.mesh.devices.size} devices")
    global_plane = multihost_utils.host_local_array_to_global_array(
        np.asarray(plane), flat.mesh, spec)

    dt = np.dtype(band_ops.default_dtype())
    fn = sharded._plane_encode_fn(
        band_ops.config_key(config), dt.name, flat.mesh,
        tuple(global_plane.shape))
    levels = fn(global_plane)

    # Host-local entropy over exactly the block rows this host's devices
    # hold: no host ever materializes the full coefficient tensor.  The
    # addressable shards of the jit output are contiguous row ranges.
    seen = {}
    for sh in levels.addressable_shards:
        seen.setdefault(sh.index[0].start or 0, np.asarray(sh.data))
    shards = sorted(seen.items())
    expect = shards[0][0]
    for start, data in shards:
        if start != expect:
            raise ValueError(
                "this host's level shards are not contiguous in global "
                "block order; use a process-contiguous device mesh")
        expect = start + data.shape[0]
    local_start = shards[0][0]
    # Rows past num_blocks are the zero blocks that pad the block count to
    # a multiple of the device count (sharded._plane_encode_fn).
    local_levels = np.concatenate([d for _, d in shards], axis=0)[
        :max(0, config.num_blocks - local_start)]
    local_stream = entropy.encode_levels(local_levels)

    # All-gather (global start row, length, padded bytes); stitch sorted by
    # global block order, which byte-aligned blocks make bit-exact.
    meta = multihost_utils.process_allgather(
        jnp.asarray([local_start, len(local_stream)], jnp.int32))
    meta = np.asarray(meta).reshape(nproc, 2)
    cap = int(meta[:, 1].max())
    padded = np.zeros(cap, np.uint8)
    padded[:len(local_stream)] = np.frombuffer(local_stream, np.uint8)
    streams = np.asarray(multihost_utils.process_allgather(
        jnp.asarray(padded))).reshape(nproc, cap)
    # Stitch in global block order; duplicate start offsets mean replicated
    # shards (e.g. an unshardable levels tensor) — keep one copy.
    order = np.argsort(meta[:, 0], kind="stable")
    parts, last_start = [], None
    for p in order:
        if last_start is not None and int(meta[p, 0]) == last_start:
            continue
        last_start = int(meta[p, 0])
        parts.append(streams[p, :int(meta[p, 1])].tobytes())
    return sharded.stitch_streams(parts)


_DIST_FNS: dict = {}


def decompress_plane_distributed(stream: bytes, config: Configuration,
                                 mesh=None) -> np.ndarray:
    """Distributed decode dual of :func:`compress_plane_distributed`
    (reference decode stack: pipeline/__init__.py:79-88, decompress.py:5-10).

    Args:
      stream: the FULL band stream, present on every host — exactly how
        :func:`compress_plane_distributed` ends (every host materializes
        the stitched stream; compressed bytes are the cheapest thing to
        replicate between processes).
    Returns:
      this host's contiguous share of the reconstructed plane rows (the
      whole plane when the geometry forces replication), bit-equal to the
      serial decoder's corresponding rows.

    Each host scans the stream ONCE in the O(bytes) GIL-releasing scanner
    (duplicated across hosts, never exchanged — rescanning locally is
    cheaper than shipping offsets between processes for any realistic
    stream), then
    uploads ONLY its own devices' contiguous block slices
    (sharded._shard_stream_slices); the lockstep bit parse runs under
    ``shard_map`` and the IDCT stays row-band sharded.
    """
    nproc = jax.process_count()
    if mesh is None:
        mesh = global_mesh()
    if nproc <= 1:
        return sharded.decompress_plane(stream, config, mesh)

    from jax.experimental import multihost_utils
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from ..entropy import device_codec as DC

    nb, L = config.num_blocks, config.dct_size ** 2
    scan = entropy.scan_offsets(stream, nb, L)     # validates the stream
    flatm = Mesh(mesh.devices.reshape(-1), (mesh_lib.BAND_AXIS,))
    ndev = int(flatm.devices.size)
    slices, local_starts = sharded._shard_stream_slices(
        [stream], [scan], ndev)

    # Host-local rows of the per-device slice tables, contiguous in mesh
    # order (same process-contiguity requirement as the encode path).
    pidx = jax.process_index()
    mine = [k for k, d in enumerate(flatm.devices.flat)
            if d.process_index == pidx]
    if not mine:
        raise ValueError(
            "this process owns no devices in the provided mesh")
    if mine != list(range(mine[0], mine[0] + len(mine))):
        raise ValueError(
            "this process's devices are not contiguous in mesh order; use "
            "a process-contiguous device mesh")
    spec = P(mesh_lib.BAND_AXIS, None)
    lo, hi = mine[0], mine[0] + len(mine)
    g_slices = multihost_utils.host_local_array_to_global_array(
        slices[lo:hi], flatm, spec)
    g_starts = multihost_utils.host_local_array_to_global_array(
        local_starts[lo:hi], flatm, spec)

    dt = np.dtype(band_ops.default_dtype())
    key = band_ops.config_key(config)
    cache_key = (key, dt.name, flatm, slices.shape, local_starts.shape)
    fn = _DIST_FNS.get(cache_key)
    if fn is None:
        decode_one = band_ops.make_decode(key, dt.name)
        lv_sh = NamedSharding(flatm, mesh_lib.fit_spec(
            (nb, L), flatm, spec))
        out_sh = NamedSharding(flatm, mesh_lib.fit_spec(
            (config.height, config.width), flatm, spec))

        def parse_local(sl, st):
            return DC.decode_stream(sl[0], st[0], L)[None]

        def step(sl, st):
            lv = jax.shard_map(parse_local, mesh=flatm,
                               in_specs=(spec, spec),
                               out_specs=P(mesh_lib.BAND_AXIS, None, None)
                               )(sl, st)
            levels = jax.lax.with_sharding_constraint(
                lv.reshape(-1, L)[:nb], lv_sh)
            return decode_one(levels)

        fn = jax.jit(step, out_shardings=out_sh)
        _DIST_FNS[cache_key] = fn
    plane = fn(g_slices, g_starts)

    # Host-local rows out, deduplicated (a replicated plane appears once
    # per device at row 0) and checked contiguous — mirror of the encode
    # path's shard handling.
    seen = {}
    for sh in plane.addressable_shards:
        seen.setdefault(sh.index[0].start or 0, np.asarray(sh.data))
    shards = sorted(seen.items())
    expect = shards[0][0]
    for start, data in shards:
        if start != expect:
            raise ValueError(
                "this host's plane shards are not contiguous in row order")
        expect = start + data.shape[0]
    return np.concatenate([d for _, d in shards], axis=0)


def compress_batch_distributed(images, config: Configuration,
                               verify: bool = False):
    """Pure-DP multi-host BATCH encode — BASELINE config 5's real shape
    (replaces the reference's serial per-band loop,
    pipeline/__init__.py:102-110, at cluster scale).

    Every process receives the SAME ordered batch description; process p
    encodes the images whose index i satisfies ``i % nproc == p`` on its
    OWN local devices (api.compress_many pipelining) — pixels and
    container bytes never cross processes.  Only a per-image manifest (byte
    count, ok flag, optional PSNR milli-dB) is allgathered, so every host
    returns identical global metrics while blobs stay host-local.

    Args:
      images: sequence over the FULL batch, identically ordered on every
        process.  Each element is an (H, W, 3) uint8 YCbCr array or a
        zero-arg callable returning one (lazy: only OWNED images are ever
        loaded).  All images must match ``config``'s dimensions.
      verify: decode each owned blob and record PSNR in the manifest.

    Returns:
      ``(blobs, manifest)``: ``blobs[i]`` is the container bytes for every
      image this process owns and ``None`` elsewhere; ``manifest`` is a
      (B, 3) int64 array — [bytes, ok, psnr_milli_db or -1] — identical on
      all hosts (bytes = 0 marks a failed image).
    """
    from jax.experimental import multihost_utils
    from ..api import compress_many, decompress_to_ycbcr, psnr

    nproc = jax.process_count()
    pid = jax.process_index()
    items = list(images)
    B = len(items)
    owned = list(range(pid, B, nproc))

    arrays, idxs = [], []
    local = np.zeros((B, 3), np.int64)
    local[:, 2] = -1
    for i in owned:
        try:
            a = items[i]() if callable(items[i]) else np.asarray(items[i])
            if a.shape[:2] != (config.height, config.width):
                raise ValueError(
                    f"image {i} is {a.shape[:2]}, config says "
                    f"{(config.height, config.width)}")
            arrays.append(a)
            idxs.append(i)
        except Exception as e:  # noqa: BLE001 — skip-and-report semantics
            import sys
            print(f"SKIP image {i}: {e}", file=sys.stderr)

    blobs: list = [None] * B
    if arrays:
        encoded = compress_many(arrays, config)
        for i, a, blob in zip(idxs, arrays, encoded):
            blobs[i] = blob
            local[i, 0] = len(blob)
            local[i, 1] = 1
            if verify:
                local[i, 2] = int(round(
                    1000 * psnr(a, decompress_to_ycbcr(blob))))

    if nproc <= 1:
        return blobs, local
    # Manifest-only traffic: (nproc, B, 3) -> elementwise max keeps
    # each image's single owner entry (all other rows are zero/-1).
    gathered = np.asarray(multihost_utils.process_allgather(
        jnp.asarray(local)))
    manifest = gathered.max(axis=0)
    return blobs, manifest
