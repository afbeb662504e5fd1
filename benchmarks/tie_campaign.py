"""f32 contract campaign: randomized ragged geometries x quantizers, the
f32 encode and decode programs (x64 off, as in production) vs the
independent f64 oracle under the +-1-at-provable-ties contract
(jpeg_tpu/utils/parity.py).

The f64 parity campaign (parity_campaign.py) proves byte parity with the
live reference in x64 mode; THIS campaign proves the f32 fast path's
honest contract — every disagreement with the f64 reference is a +-1 flip
at an exact half-integer rounding tie of the f64 value.

Usage:  JAX_PLATFORMS=cpu python benchmarks/tie_campaign.py [N] [SEED]

Prints one summary line; exit code 0 iff every draw satisfies the
contract.  Runs on the CPU backend; chip_smoke.py checks the same contract
on the GPU at full image sizes.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from jpeg_tpu.config import Configuration, QuantizationMethod  # noqa: E402
from jpeg_tpu.ops import band as band_ops  # noqa: E402
from jpeg_tpu.utils import parity as PAR  # noqa: E402


def _draw(rng):
    d = int(rng.choice([2, 3, 4, 8, 12, 16, 24]))
    bs = int(rng.integers(1, 5))
    tr = str(rng.choice(["DCT", "DCT", "DFT"]))
    qname = str(rng.choice(["none", "discard", "divide", "qtable"]))
    if qname == "qtable":
        d = 8
    params = {}
    if qname == "discard":
        params = {"keep": int(rng.integers(1, d + 1))}
    elif qname == "divide":
        params = {"divisor": int(rng.choice([2, 13, 40, 129, 1000]))}
    # Bias hard toward ragged geometry (non-divisible at both stages).
    w = int(rng.integers(1, 4 * bs * d + 7))
    h = int(rng.integers(1, 4 * bs * d + 7))
    return Configuration(width=w, height=h, block_size=bs, dct_size=d,
                         transform=tr,
                         quantization=QuantizationMethod(qname, **params))


def main(n=200, seed=20260820):
    rng = np.random.default_rng(seed)
    flips_enc = flips_dec = 0
    for i in range(n):
        cfg = _draw(rng)
        key = band_ops.config_key(cfg)
        band = rng.integers(0, 256, (cfg.height, cfg.width)).astype(np.int32)
        desc = (f"w={cfg.width} h={cfg.height} bs={cfg.block_size} "
                f"d={cfg.dct_size} {cfg.transform} {cfg.quantization.name}")
        try:
            f = jax.jit(band_ops.make_encode(key, "float32"))
            g = jax.jit(band_ops.make_decode(key, "float32"))
            lv = np.asarray(f(band))
            lv_ref, et = PAR.encode_reference_and_ties(cfg, band)
            PAR.assert_tie_equal(lv, lv_ref, et, "encode f32 vs f64")
            px = np.asarray(g(lv))
            px_ref, dt = PAR.decode_reference_and_ties(cfg, lv)
            PAR.assert_tie_equal(px, px_ref, dt, "decode f32 vs f64")
        except AssertionError as e:
            print(f"FAIL draw {i} ({desc}): {e}")
            return 1
        flips_enc += int((lv != lv_ref).any())
        flips_dec += int((px != px_ref).any())
        if (i + 1) % 25 == 0:
            print(f"  {i + 1}/{n} ...", flush=True)
    print(f"{n}/{n} draws satisfy the f32 tie contract "
          f"({flips_enc} draws had encode tie flips, {flips_dec} decode)")
    return 0


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 20260820
    sys.exit(main(n, seed))
