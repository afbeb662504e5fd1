"""Device<->host transfer helpers shared by the API and sharded paths."""
from __future__ import annotations

import numpy as np


def pow2_cap(n: int, floor: int = 4096) -> int:
    """Smallest power of two >= n (min ``floor``).

    Slice lengths are rounded to powers of two so the number of distinct
    slice executables (each a fresh XLA compile) stays logarithmic in the
    observed sizes."""
    cap = floor
    while cap < n:
        cap <<= 1
    return cap


def quarter_cap(n: int, floor: int = 4096) -> int:
    """Smallest quarter-octave size (m * 2^k / 4, m in 4..7) >= n.

    Same bounded-compile-count rationale as :func:`pow2_cap` (4 sizes per
    octave instead of 1), but the worst-case padding drops from 2x to
    1.25x — used where the padded length IS the work, e.g. the per-byte
    boundary-scan walkers (entropy/device_scan.py)."""
    cap = pow2_cap(n, floor)
    if cap > floor:
        q = cap >> 3                     # candidates (cap/2) * {1.25, 1.5, 1.75}
        for m in (5, 6, 7):
            if q * m >= n:
                return q * m
    return cap


def pull_prefix(dev_u8, nbytes: int) -> bytes:
    """Transfer only the used prefix of a device byte buffer."""
    n = int(nbytes)
    cap = min(pow2_cap(n), dev_u8.shape[0])
    return np.asarray(dev_u8[:cap])[:n].tobytes()


def device_entropy_default(platform: str | None = None) -> bool:
    """The one policy that places entropy coding (encode and decode) on the
    device (entropy/device_codec.py, plain XLA) or the host C++ codec.

    On a GPU the device side won both directions of a host-vs-device
    measurement on an H100 at 2048x2048 (PERF.md); every other platform
    keeps the host codec.  ``platform`` defaults to JAX's default backend.
    """
    if platform is None:
        import jax
        platform = jax.default_backend()
    return platform == "gpu"
