"""jpeg_tpu — a JPEG-style image codec on the GPU (JAX / XLA).

A from-scratch re-design of the reference educational JPEG codec
(X-rayLaser/Implementing-JPEG-compression) with the same wire format and
behavior, run as device programs:

  * The whole per-band transform path (pad, subsample, blockwise DCT/DFT,
    quantize, zigzag) is one jitted function whose hot op is a single
    ``(num_blocks, d*d) @ (d*d, d*d)`` matmul (see ops/transform.py).
  * Entropy coding runs on the device (prefix sums + scatter encode,
    lock-step decode; entropy/device_codec.py) or on the host (vectorized
    NumPy, C++ fast path); utils/device.py places it per platform.
  * Scaling is mesh-native: batches of images shard over a ``data`` axis and
    single large images tile row-band-wise over a ``rows`` axis with the
    per-band bitstreams stitched via length all-gather (see parallel/).
"""

from .config import (BadArrayShapeError, BadQuantizationError,
                     BadRleCodeError, BadStreamError, Configuration,
                     EmptyArrayError, QuantizationMethod, padded_size)
from .container import (CompressedData, create_header, generate_data,
                        get_header, read_data)
from .api import (Jpeg, compress_band, compress_many, compress_ycbcr,
                  decompress_band, decompress_many,
                  decompress_to_device, decompress_to_ycbcr, psnr)
from . import steps  # invertible step-pipeline view (steps.step_classes)

__version__ = "0.1.0"

__all__ = [
    "BadArrayShapeError", "BadQuantizationError", "BadRleCodeError",
    "BadStreamError", "CompressedData", "Configuration", "EmptyArrayError",
    "Jpeg", "QuantizationMethod", "compress_band", "compress_many",
    "compress_ycbcr",
    "create_header", "decompress_band", "decompress_many",
    "decompress_to_device", "decompress_to_ycbcr",
    "generate_data", "get_header", "padded_size", "psnr", "read_data",
]
