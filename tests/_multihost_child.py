"""Child process for the real 2-process multihost test.

Usage: python _multihost_child.py <coordinator> <nproc> <pid> <outdir>

Each process owns 4 virtual CPU devices (XLA_FLAGS set by the parent), joins
the distributed runtime over localhost DCN, and runs
``compress_plane_distributed`` twice:

* ``sharded``    — 128x128 plane whose 64 block rows shard 8 ways, so each
  host entropy-codes only its own contiguous half (the
  host_local_array_to_global_array + process_allgather stitch path).
* ``replicated`` — 64x48 plane whose 12 blocks don't divide the mesh, so the
  levels replicate and the duplicate-start dedup keeps one copy.

The stitched stream (identical on every process) is written to
``<outdir>/stream_<name>_<pid>.bin`` for the parent to compare against the
serial encoder.
"""
import os
import sys

import numpy as np


def synth_plane(h, w):
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    return np.clip(128 + 80 * np.sin(x / 7.0) * np.cos(y / 5.0)
                   + 25 * np.sin((x + 2 * y) / 11.0), 0, 255).astype(int)


def synth_image(h, w, seed):
    """(H, W, 3) uint8 YCbCr image, content varied by seed."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    bands = [np.clip(128 + 70 * np.sin(x / (5 + seed + k))
                     * np.cos(y / (7 + 2 * k)) + 10 * seed, 0, 255)
             for k in range(3)]
    return np.stack(bands, axis=-1).astype(np.uint8)


def main():
    coordinator, nproc, pid, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    import jax
    # Force CPU before backend init (the parent may run beside a card).
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)   # parity mode, like conftest
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc
    assert len(jax.devices()) == nproc * 4, jax.devices()

    from jpeg_tpu.config import Configuration, QuantizationMethod
    from jpeg_tpu.parallel import mesh as mesh_lib
    from jpeg_tpu.parallel import multihost

    mesh = mesh_lib.make_mesh(data=1, band=nproc * 4)
    for name, (h, w) in [("sharded", (128, 128)), ("replicated", (64, 48))]:
        cfg = Configuration(width=w, height=h, block_size=2, dct_size=8,
                            quantization=QuantizationMethod("qtable"))
        plane = synth_plane(h, w)
        rows = h // nproc
        local = plane[pid * rows:(pid + 1) * rows]
        stream = multihost.compress_plane_distributed(local, cfg, mesh)
        with open(os.path.join(outdir, f"stream_{name}_{pid}.bin"), "wb") as f:
            f.write(stream)
        # Decode dual: full stream in (every host holds it after the
        # stitch), host-local reconstructed rows out.
        local_rows = multihost.decompress_plane_distributed(stream, cfg, mesh)
        np.save(os.path.join(outdir, f"rows_{name}_{pid}.npy"), local_rows)

    # Batch phase: pure-DP multi-host batch encode (BASELINE config 5's
    # shape) — per-host image ownership, manifest-only DCN traffic.
    bh, bw = 40, 56
    cfg = Configuration(width=bw, height=bh, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    # Lazy loaders: only OWNED images may ever be materialized; a non-owned
    # loader raising would fail the run.
    B = 5

    def loader(i):
        def load():
            assert i % nproc == pid, f"process {pid} loaded foreign image {i}"
            return synth_image(bh, bw, i)
        return load

    blobs, manifest = multihost.compress_batch_distributed(
        [loader(i) for i in range(B)], cfg, verify=True)
    np.save(os.path.join(outdir, f"manifest_{pid}.npy"), manifest)
    for i, blob in enumerate(blobs):
        assert (blob is not None) == (i % nproc == pid), (i, pid)
        if blob is not None:
            with open(os.path.join(outdir, f"batch_{i}.bin"), "wb") as f:
                f.write(blob)
    print("child done", pid, flush=True)


if __name__ == "__main__":
    main()
