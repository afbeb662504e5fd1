"""Distributed execution: device meshes, sharded encode, bitstream stitch.

The reference has no parallelism of any kind (single process, serial bands;
reference: pipeline/__init__.py:102-110).  This package provides the
scaling axes mapped out in SURVEY.md §2b: batch data-parallelism,
row-band spatial tiling (the CP/SP analog), and the byte-aligned bitstream
stitch that makes distributed entropy output exactly equal to the serial
stream.
"""
from .mesh import (BAND_AXIS, DATA_AXIS, batch_sharding, factorize,
                   levels_sharding, make_mesh, plane_sharding, replicated)
from .sharded import (compress_batch, compress_plane, decompress_batch,
                      decompress_plane, encode_batch_levels, stitch_streams)
from .stats import block_bits, block_bytes, total_bytes

__all__ = [
    "BAND_AXIS", "DATA_AXIS", "batch_sharding", "factorize",
    "levels_sharding", "make_mesh", "plane_sharding", "replicated",
    "compress_batch", "compress_plane",
    "decompress_batch", "decompress_plane",
    "encode_batch_levels", "stitch_streams",
    "block_bits", "block_bytes", "total_bytes",
]
