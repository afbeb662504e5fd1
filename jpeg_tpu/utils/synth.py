"""Seeded photograph-like test content for benchmarks and the chip check."""
from __future__ import annotations

import numpy as np


def synth_image(h: int, w: int, channels: int = 3,
                seed: int = 7) -> np.ndarray:
    """Natural-image-like content: smooth structure + texture + mild noise.

    Pure random noise is the worst case for any entropy coder and looks
    nothing like the photographic inputs the codec targets.  Returns an
    (h, w, channels) uint8 array.
    """
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for c in range(channels):
        plane = (128
                 + 70 * np.sin(x / (17 + 6 * c)) * np.cos(y / (23 - 4 * c))
                 + 30 * np.sin((x + y) / (9 + 2 * c))
                 + 8 * rng.standard_normal((h, w)))
        out.append(np.clip(plane, 0, 255))
    return np.stack(out, axis=-1).astype(np.uint8)
