"""Compute ops: pixel-domain kernels, transforms, quantizers, fused band path.

Submodules:
  blocks         pad/crop/subsample/inflate/blockify (jit-safe jnp)
  transform      fused DCT+zigzag operators, DFT, parity-exact host paths,
                 classic DCT/Zigzag drop-in classes
  quantize       the four quantizer semantics (functional + classic classes)
  band           the fused per-band pixels<->levels pipeline
"""
from . import band, blocks, quantize, transform

__all__ = ["band", "blocks", "quantize", "transform"]
