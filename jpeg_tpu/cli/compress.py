"""CLI: compress an image — drop-in for the reference's compress.py.

Same flags and defaults (reference compress.py:24-62: block_size 4,
dct_size 8, transform DCT, quantization 'qtable', qkeep 2, qdivisor 40),
plus execution flags (dtype, device mesh).
"""
from __future__ import annotations

import argparse
from typing import Optional

from ..api import Jpeg
from ..config import Configuration, QuantizationMethod


def compress(input_fname: str, output_fname: str, block_size: int = 4,
             dct_size: int = 8, transform: str = "DCT",
             quantization: Optional[QuantizationMethod] = None,
             dtype=None, mesh: bool = False) -> None:
    from PIL import Image
    im = Image.open(input_fname).convert("YCbCr")
    config = Configuration(width=im.width, height=im.height,
                           block_size=block_size, dct_size=dct_size,
                           transform=transform, quantization=quantization)
    if mesh:
        # Row-band tiling over every available device; identical bytes to
        # the single-device path (byte-aligned bitstream stitch).
        import numpy as np
        from .. import container, parallel
        from ..container import CompressedData
        m = parallel.make_mesh()
        arr = np.asarray(im)
        bands = [parallel.compress_plane(arr[:, :, i].astype(np.int32),
                                         config, m, dtype=dtype)
                 for i in range(3)]
        compressed = container.generate_data(config, CompressedData(*bands))
    else:
        compressed = Jpeg(config, dtype=dtype).compress(im)
    with open(output_fname, "wb") as f:
        f.write(compressed)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Given an image, compress it using JPEG algorithm")
    parser.add_argument("infile", type=str,
                        help="a path to the file to compress")
    parser.add_argument("outfile", type=str, help="a destination path")
    parser.add_argument("--block_size", action="store", type=int, default=4,
                        help="size of sub-sampling block")
    parser.add_argument("--dct_size", action="store", type=int, default=8,
                        help="size of block for DCT transform")
    parser.add_argument("--transform", action="store", type=str,
                        default="DCT",
                        help="type of discrete transform (DCT vs DFT)")
    parser.add_argument("--quantization", action="store", type=str,
                        default="qtable",
                        help="type of quantization to use: "
                             "one of none, discard, divide, qtable")
    parser.add_argument("--qkeep", action="store", type=int, default=2,
                        help="how many coefficients to keep along both axes "
                             "(quantization == 'discard')")
    parser.add_argument("--qdivisor", action="store", type=int, default=40,
                        help="integer used to divide coefficients by "
                             "(quantization == 'divide')")
    parser.add_argument("--dtype", action="store", type=str, default=None,
                        help="compute dtype override (float32/float64)")
    parser.add_argument("--mesh", action="store_true",
                        help="row-band-tile each band over all devices")
    return parser


def quantization_from_args(args: argparse.Namespace):
    if args.quantization == "discard":
        return QuantizationMethod("discard", keep=args.qkeep)
    if args.quantization == "divide":
        return QuantizationMethod("divide", divisor=args.qdivisor)
    if args.quantization == "qtable":
        return QuantizationMethod("qtable")
    return None


def main(argv=None) -> None:
    from ..utils.jit_cache import enable_persistent_cache
    enable_persistent_cache()
    args = build_parser().parse_args(argv)
    compress(args.infile, args.outfile, block_size=args.block_size,
             dct_size=args.dct_size, transform=args.transform,
             quantization=quantization_from_args(args), dtype=args.dtype,
             mesh=args.mesh)


if __name__ == "__main__":
    main()
