"""Mesh-scaling curve: row-band encode throughput vs device count.

Usage: python benchmarks/scaling.py [H W reps]
       BENCH_CPU_DEVICES=8 python benchmarks/scaling.py   # virtual CPU mesh

Without BENCH_CPU_DEVICES it runs on the GPUs JAX finds (one process
drives every card of the host) and fails if there are none.  With it, the
script exercises the sharding machinery over virtual CPU devices: a
functional check whose times are CPU times, not device metrics.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")

ndev = int(os.environ.get("BENCH_CPU_DEVICES", 0))
if ndev:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={ndev}")

import jax  # noqa: E402

if ndev:
    jax.config.update("jax_platforms", "cpu")
elif jax.devices()[0].platform != "gpu":
    sys.exit(f"scaling.py measures GPUs; JAX found "
             f"{jax.devices()[0].platform!r} (BENCH_CPU_DEVICES=n for a "
             f"virtual CPU mesh)")

from jpeg_tpu import Configuration, QuantizationMethod, parallel  # noqa: E402


def main() -> None:
    h = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    w = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 3

    cfg = Configuration(width=w, height=h, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    y, x = np.mgrid[0:h, 0:w]
    plane = np.clip(128 + 80 * np.sin(x / 37.0) * np.cos(y / 23.0),
                    0, 255).astype(np.int32)

    total = len(jax.devices())
    sizes = sorted({n for n in (1, 2, 4, 8, 16, total) if n <= total})
    print(f"backend={jax.default_backend()} "
          f"kind={jax.devices()[0].device_kind} devices={total} "
          f"plane={h}x{w}")
    base = None
    for n in sizes:
        mesh = parallel.make_mesh(n)
        parallel.compress_plane(plane, cfg, mesh, dtype=np.float32)  # warm
        t0 = time.perf_counter()
        for _ in range(reps):
            parallel.compress_plane(plane, cfg, mesh, dtype=np.float32)
        dt = (time.perf_counter() - t0) / reps
        mps = h * w / dt / 1e6
        base = base or mps
        print(f"  {n:2d} devices: {dt * 1e3:8.1f} ms  {mps:7.1f} MP/s  "
              f"speedup {mps / base:.2f}x")


if __name__ == "__main__":
    main()
