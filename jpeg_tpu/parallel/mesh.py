"""Device-mesh construction for the codec's two parallel axes.

The reference is strictly serial (one process, one image, one band at a time;
reference: pipeline/__init__.py:102-110).  This codec scales
along two orthogonal axes (SURVEY.md §2b):

* ``data``  — batch of images (pure DP; images are independent).
* ``band``  — row-bands of a single image (the SP/CP analog; DCT blocks are
  spatially independent, so sharding image rows only requires GSPMD's
  automatic halo exchange at pad/subsample seams).

Axes are expressed as a :class:`jax.sharding.Mesh`; all cross-device
communication is XLA collectives inserted by GSPMD from sharding
annotations — there is no hand-written NCCL/MPI analog.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
BAND_AXIS = "band"


def factorize(n: int, max_band: int = 8) -> Tuple[int, int]:
    """Split ``n`` devices into (data, band) axis sizes.

    Prefers the largest power-of-two band axis <= ``max_band`` that divides
    ``n``; row-band sharding keeps per-chip blocks contiguous so a modest
    band axis is enough, and the rest goes to embarrassingly-parallel data.
    """
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    band = 1
    for cand in (8, 4, 2):
        if cand <= max_band and n % cand == 0:
            band = cand
            break
    return n // band, band


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[jax.Device]] = None,
              data: Optional[int] = None,
              band: Optional[int] = None) -> Mesh:
    """Build a ``(data, band)`` mesh over the first ``n_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        if data is not None and band is not None:
            n_devices = data * band
        else:
            n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} available")
    devices = list(devices)[:n_devices]
    n = len(devices)
    if data is None and band is None:
        data, band = factorize(n)
    elif data is None:
        if n % band:
            raise ValueError(f"band={band} does not divide {n} devices")
        data = n // band
    elif band is None:
        if n % data:
            raise ValueError(f"data={data} does not divide {n} devices")
        band = n // data
    if data * band != len(devices):
        raise ValueError(
            f"mesh {data}x{band} does not match {len(devices)} devices")
    arr = np.asarray(devices).reshape(data, band)
    return Mesh(arr, (DATA_AXIS, BAND_AXIS))


def fit_spec(shape: Sequence[int], mesh: Mesh, spec: P) -> P:
    """Drop partition entries whose axis size doesn't divide the dimension.

    jit shardings require exact divisibility; padding geometry (odd block
    counts, small batches) often breaks it on one axis, in which case that
    dimension simply stays replicated/unsharded.  Dropping a requested axis
    is correct but silently serializes that dimension's work, so it warns
    (once per call site by Python's default warning filter).
    """
    import warnings
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    fitted = []
    for dim, name in zip(shape, tuple(spec) + (None,) * len(shape)):
        if name is not None and dim % sizes[name] == 0:
            fitted.append(name)
        else:
            if name is not None and sizes[name] > 1:
                warnings.warn(
                    f"dimension of size {dim} is not divisible by mesh axis "
                    f"{name!r} ({sizes[name]} devices); leaving it "
                    f"unsharded — pad the batch/rows for full parallelism",
                    stacklevel=2)
            fitted.append(None)
    return P(*fitted)


def batch_sharding(mesh: Mesh, shape: Sequence[int]) -> NamedSharding:
    """(B, H, W) image-band batches: batch over data, rows over band."""
    return NamedSharding(mesh, fit_spec(shape, mesh,
                                        P(DATA_AXIS, BAND_AXIS, None)))


def levels_sharding(mesh: Mesh, shape: Sequence[int]) -> NamedSharding:
    """(B, num_blocks, L) levels: block axis follows the row-band axis."""
    return NamedSharding(mesh, fit_spec(shape, mesh,
                                        P(DATA_AXIS, BAND_AXIS, None)))


def plane_sharding(mesh: Mesh, shape: Sequence[int]) -> NamedSharding:
    """(H, W) single plane: rows over the flattened device axis."""
    flat = Mesh(mesh.devices.reshape(-1), (BAND_AXIS,))
    return NamedSharding(flat, fit_spec(shape, flat, P(BAND_AXIS, None)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
