"""Per-stage encode/decode timing on the GPU, and the entropy placement A/B.

Usage:  python benchmarks/stages.py [H W [reps]]

Prints the card's name and power limit, then

* fenced stages of one qtable / block_size 2 / dct_size 8 image: the
  coefficient program with the int16 level pull, the host C++ entropy
  encode and decode of those levels, the device entropy encode program and
  the device decode program (stream upload + bit parse + IDCT);
* the placement A/B that ``utils/device.py:device_entropy_default`` rests
  on: host->host ``compress_ycbcr`` and ``decompress_to_ycbcr`` with entropy
  coding on the host and on the device, in turns (host, device, device,
  host per rep), as medians and quartiles over all turns;
* how many lock-step steps the device decoder takes for this image.

Every time is host wall clock around work whose result has been pulled or
waited on.  Fails when JAX finds no GPU.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _ms(v) -> str:
    q1, med, q3 = np.percentile(np.asarray(v) * 1e3, [25, 50, 75])
    return f"median {med:.3f} ms (q1 {q1:.3f}, q3 {q3:.3f}, n={len(v)})"


def main() -> None:
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"stages.py measures the GPU; JAX found {dev.platform!r}")
    from jpeg_tpu.utils.jit_cache import enable_persistent_cache
    enable_persistent_cache()
    from jpeg_tpu import (Configuration, QuantizationMethod, api,
                          container, entropy)
    from jpeg_tpu.ops import band as band_ops
    from jpeg_tpu.utils import parity
    from jpeg_tpu.utils.synth import synth_image

    h = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    w = int(sys.argv[2]) if len(sys.argv) > 2 else 2048
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"jax {jax.__version__} {dev.device_kind} image={h}x{w}x3 "
          f"reps={reps}", flush=True)

    cfg = Configuration(width=w, height=h, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    img = synth_image(h, w)
    key = band_ops.config_key(cfg)
    planes = np.ascontiguousarray(img.transpose(2, 0, 1))
    nb, L = cfg.num_blocks, cfg.dct_size ** 2

    def set_placement(on_device: bool) -> None:
        api._use_device_entropy = lambda: on_device

    blobs = {}
    for side in (False, True):                    # warm every program
        set_placement(side)
        blobs[side] = api.compress_ycbcr(img, cfg)
        api.decompress_to_ycbcr(blobs[side])
    print(f"compressed {img.nbytes} -> {len(blobs[True])} bytes; device "
          f"and host containers identical: {blobs[True] == blobs[False]}")

    # -- fenced stages
    enc_levels = api._encode3_fn(key, "float32")
    enc_stream = api._encode3_stream_fn(key, "float32")
    _, data = container.read_data(blobs[False])
    streams = [data.y, data.cb, data.cr]
    lv_host = np.stack([entropy.decode_levels(s, nb, L) for s in streams])
    stage = {k: [] for k in ("coeff program + int16 level pull",
                             "host C++ entropy encode (3 bands, serial)",
                             "host C++ entropy decode (3 bands, serial)",
                             "device encode program + stream pull",
                             "device decode (upload+scan+parse+IDCT+pull)")}
    names = list(stage)
    for _ in range(reps):
        t0 = time.perf_counter()
        lv16, mx = enc_levels(planes)
        lv = np.asarray(lv16)
        stage[names[0]].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        [entropy.encode_levels(b) for b in lv]
        stage[names[1]].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        [entropy.decode_levels(s, nb, L) for s in streams]
        stage[names[2]].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        buf, band_bytes, mx = enc_stream(planes)
        api._pull_prefix(buf, int(np.asarray(band_bytes).sum()))
        stage[names[3]].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        np.asarray(api._host_scan_decompress(cfg, streams,
                                             np.dtype(np.float32)))
        stage[names[4]].append(time.perf_counter() - t0)
    for k, v in stage.items():
        print(f"  {k:45s} {_ms(v)}")

    # -- placement A/B, host -> host, in turns
    ab = {(d, s): [] for d in ("encode", "decode") for s in (False, True)}
    for _ in range(reps):
        for side in (False, True, True, False):
            set_placement(side)
            t0 = time.perf_counter()
            api.compress_ycbcr(img, cfg)
            ab[("encode", side)].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            api.decompress_to_ycbcr(blobs[side])
            ab[("decode", side)].append(time.perf_counter() - t0)
    for (d, side), v in ab.items():
        print(f"  placement {d} on {'device' if side else 'host':6s} {_ms(v)}")
    print(f"device decode steps for this image: "
          f"{parity.decode_steps(lv_host)}")


if __name__ == "__main__":
    main()
