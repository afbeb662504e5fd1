"""Chip check: run the codec's main path on an NVIDIA GPU and check it.

    python chip_smoke.py               # phases 1-4, one card
    python chip_smoke.py --four-cards  # phase 5 only, four cards

Phases (one process; every check that fails makes the script exit nonzero):

1. 2048x2048 RGB, qtable / block_size 2 / dct_size 8, through
   ``compress_ycbcr`` -> ``decompress_to_ycbcr``, then ``compress_many`` /
   ``decompress_many`` over three images and ``decompress_to_device``.
2. A 12 MP phone photo (4032x3024) at the CLI defaults (qtable, bs 4, d 8),
   serial API.
3. The other BASELINE.json configurations at 2048x2048: raw rounding on
   grayscale content, RGB block_size 5, divide-1000 at dct_size 24, DFT.
4. Foreign decode through the device boundary scan (JPEG_TPU_SCAN=device):
   planes equal phase 1's.
5. (--four-cards) ``parallel.compress_batch`` / ``decompress_batch`` of four
   3840x2160 frames and ``parallel.compress_plane`` / ``decompress_plane``
   of one 10980x10980 plane on a 4-card mesh, byte-identical to the same
   calls on one card.

Checks of phases 1-3: the levels in each container (read back with the
host C++ codec) equal the f64 oracle except +-1 at provable round ties
(utils/parity.py); re-encoding those levels with the host C++ codec gives
the container's streams byte for byte; the decoded planes equal the f64
oracle's decode of those levels except at ties; pipelined results equal
serial ones; PSNR against the input is above 30 dB for phase 1 and, for
the other configurations, no lower than the f64 oracle's own PSNR.

Earlier lines report the card, the versions, the entropy placement and,
per phase, wall time and tie counts.  The last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu(devices, count: int = 1) -> None:
    """Refuse to run anywhere but on ``count`` GPU devices."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {plat!r}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX found "
                         f"{len(devices)}")


def tie_counts(got, want, ties) -> dict:
    """Check the +-1-at-provable-ties contract and count what it allowed.

    Returns {"n": elements, "ties": tie-flagged elements, "flips": elements
    that differ (each a +-1 at a tie)}; raises AssertionError otherwise."""
    from jpeg_tpu.utils import parity as PAR
    PAR.assert_tie_equal(got, want, ties)
    got, want = np.asarray(got), np.asarray(want)
    return {"n": int(got.size), "ties": int(np.count_nonzero(ties)),
            "flips": int(np.count_nonzero(got != want))}


def add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b[k] for k in b}


def dot_precision_findings(hlo_text: str) -> list:
    """Matrix products in compiled HLO that would not be full f32.

    Flags any dot or cuBLAS/Triton gemm whose line names TF32 or a bf16
    multi-pass algorithm, or whose operand precision is not HIGHEST."""
    bad = []
    for line in hlo_text.splitlines():
        low = line.lower()
        if not (" dot(" in low or "gemm" in low or "matmul" in low):
            continue
        if "tf32" in low or re.search(r"bf16_bf16_f32_x[36]", low):
            bad.append(line.strip()[:200])
        elif re.search(r"operand_precision=\{(default|high)\b", low) or \
                re.search(r'"operand_precision":\["(default|high)"', low):
            bad.append(line.strip()[:200])
    return bad


def count_dots(hlo_text: str) -> int:
    return sum(1 for line in hlo_text.splitlines()
               if " dot(" in line or "gemm" in line.lower())


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def say(*a) -> None:
    print(*a, flush=True)


# --------------------------------------------------------------- checks

def check_container(img, blob, planes, cfg):
    """Oracle and host-codec checks of one container and its decode.

    ``planes`` is the (H, W, 3) decode of ``blob``.  Returns (encode tie
    counts, decode tie counts, psnr, oracle psnr, decode steps)."""
    from jpeg_tpu import entropy, psnr
    from jpeg_tpu.container import read_data
    from jpeg_tpu.utils import parity as PAR
    cfg_read, data = read_data(blob)
    assert cfg_read.height == cfg.height and cfg_read.width == cfg.width
    nb, L = cfg.num_blocks, cfg.dct_size ** 2
    enc, dec, ref_planes, steps = {}, {}, [], 0
    for c, stream in enumerate((data.y, data.cb, data.cr)):
        lv = entropy.decode_levels(stream, nb, L)           # host C++
        assert entropy.encode_levels(lv) == stream, \
            f"band {c}: host re-encode of the card's levels differs"
        ref, ties = PAR.encode_reference_and_ties(cfg, img[:, :, c])
        enc = add_counts(enc, tie_counts(lv, ref, ties))
        pref, pties = PAR.decode_reference_and_ties(cfg, lv)
        dec = add_counts(dec, tie_counts(planes[:, :, c], pref, pties))
        ref_planes.append(pref)
        steps = max(steps, PAR.decode_steps(lv))
    oracle = np.clip(np.stack(ref_planes, -1), 0, 255)
    return enc, dec, psnr(img, planes), psnr(img, oracle), steps


def run_serial(name, img, cfg, min_psnr=None):
    """compress_ycbcr -> decompress_to_ycbcr with every container check."""
    from jpeg_tpu import compress_ycbcr, decompress_to_ycbcr
    t0 = time.perf_counter()
    blob = compress_ycbcr(img, cfg)
    planes = decompress_to_ycbcr(blob)
    wall = time.perf_counter() - t0
    enc, dec, p, p_ref, steps = check_container(img, blob, planes, cfg)
    floor = min_psnr if min_psnr is not None else p_ref - 0.01
    assert p > floor, f"{name}: PSNR {p:.3f} dB <= {floor:.3f} dB"
    say(f"phase {name}: {cfg.height}x{cfg.width} bs{cfg.block_size} "
        f"d{cfg.dct_size} {cfg.transform} {cfg.quantization.name}: "
        f"wall {wall:.3f} s (first call, compile included), "
        f"{len(blob)} bytes, PSNR {p:.3f} dB (f64 oracle {p_ref:.3f}), "
        f"encode ties {enc}, decode ties {dec}, decode steps {steps}")
    return blob, planes


def hlo_check(cfg, img):
    """No f32 dot of the main path's programs runs in TF32 or bf16 passes."""
    from jpeg_tpu import api
    from jpeg_tpu.ops import band as band_ops
    key = band_ops.config_key(cfg)
    bands = np.ascontiguousarray(img.transpose(2, 0, 1))
    progs = {"coeff encode (host entropy)": api._encode3_fn(key, "float32"),
             "encode + device entropy": api._encode3_stream_fn(key,
                                                               "float32")}
    lv16 = np.zeros((3, cfg.num_blocks, cfg.dct_size ** 2), np.int16)
    texts = {k: f.lower(bands).compile().as_text() for k, f in progs.items()}
    texts["coeff decode"] = api._decode3_fn(key, "float32").lower(
        lv16).compile().as_text()
    for name, text in texts.items():
        bad = dot_precision_findings(text)
        assert not bad, f"{name}: reduced-precision products: {bad[:3]}"
        say(f"hlo {name}: {count_dots(text)} dot/gemm ops, all full f32")


# --------------------------------------------------------------- phases

def phase1(n: int = 2048, min_psnr: float = 30.0):
    from jpeg_tpu import (Configuration, QuantizationMethod, compress_many,
                          compress_ycbcr, decompress_many,
                          decompress_to_device, decompress_to_ycbcr)
    from jpeg_tpu.utils.synth import synth_image
    cfg = Configuration(width=n, height=n, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    img = synth_image(n, n, seed=7)
    hlo_check(cfg, img)
    blob, planes = run_serial("1 main", img, cfg, min_psnr=min_psnr)

    imgs = [img] + [synth_image(n, n, seed=s) for s in (8, 9)]
    t0 = time.perf_counter()
    blobs = compress_many(imgs, cfg)
    recon = decompress_many(blobs)
    wall = time.perf_counter() - t0
    for i, (im, b, r) in enumerate(zip(imgs, blobs, recon)):
        assert b == compress_ycbcr(im, cfg), f"compress_many[{i}] != serial"
        np.testing.assert_array_equal(r, decompress_to_ycbcr(b))
    dev = np.asarray(decompress_to_device(blob)).transpose(1, 2, 0)
    np.testing.assert_array_equal(dev, planes)
    say(f"phase 1 pipelined: compress_many+decompress_many of 3 images "
        f"wall {wall:.3f} s; equal to serial; decompress_to_device equal")
    # Steady-state serial times (compiled): host clock, results pulled.
    times = {"encode": [], "decode": []}
    for _ in range(5):
        t0 = time.perf_counter()
        compress_ycbcr(img, cfg)
        times["encode"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        decompress_to_ycbcr(blob)
        times["decode"].append(time.perf_counter() - t0)
    say("phase 1 steady serial host->host: " + ", ".join(
        f"{k} median {np.median(v) * 1e3:.2f} ms of {len(v)}"
        for k, v in times.items()))
    return blob, planes


def phase2(h: int = 3024, w: int = 4032):
    from jpeg_tpu import Configuration, QuantizationMethod
    from jpeg_tpu.utils.synth import synth_image
    cfg = Configuration(width=w, height=h, block_size=4, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    run_serial("2 photo-12MP", synth_image(h, w, seed=12), cfg)


def phase3(n: int = 2048):
    from jpeg_tpu import Configuration, QuantizationMethod
    from jpeg_tpu.utils.synth import synth_image
    img = synth_image(n, n, seed=3)
    gray = np.repeat(synth_image(n, n, channels=1, seed=4), 3, axis=2)
    q = QuantizationMethod
    cases = [
        ("3a d8-rounding-gray", gray, dict(block_size=4, quantization=q("none"))),
        ("3b rgb-bs5", img, dict(block_size=5, quantization=q("qtable"))),
        ("3c divide1000-d24", img,
         dict(block_size=2, dct_size=24, quantization=q("divide",
                                                        divisor=1000))),
        ("3d dft", img, dict(block_size=2, transform="DFT",
                             quantization=q("none"))),
    ]
    for name, im, kw in cases:
        kw.setdefault("dct_size", 8)
        run_serial(name, im, Configuration(width=n, height=n, **kw))


def phase4(blob, planes):
    """The foreign decode with the device boundary scan: its in-program ok
    flag must hold (asserted here; the API would raise on it too) and the
    planes must equal phase 1's."""
    import jax
    from jpeg_tpu import api, decompress_to_ycbcr
    from jpeg_tpu.container import read_data
    from jpeg_tpu.ops import band as band_ops
    from jpeg_tpu.utils.device import quarter_cap
    cfg, data = read_data(blob)
    streams = [data.y, data.cb, data.cr]
    buf = b"".join(streams)
    arr = np.zeros(quarter_cap(len(buf)), np.uint8)
    arr[:len(buf)] = np.frombuffer(buf, np.uint8)
    ends = np.cumsum([len(s) for s in streams]).astype(np.int32)
    fn = api._decode3_foreign_fn(band_ops.config_key(cfg), "float32")
    direct, ok = fn(jax.device_put(arr), ends)
    assert bool(ok), "device boundary scan rejected a valid stream"
    np.testing.assert_array_equal(
        np.asarray(direct).transpose(1, 2, 0), planes)
    os.environ["JPEG_TPU_SCAN"] = "device"
    try:
        t0 = time.perf_counter()
        got = decompress_to_ycbcr(blob)
        wall = time.perf_counter() - t0
    finally:
        del os.environ["JPEG_TPU_SCAN"]
    np.testing.assert_array_equal(got, planes)
    say(f"phase 4 foreign decode (device scan, one dispatch): ok flag set; "
        f"wall {wall:.3f} s; planes equal phase 1")


def split_over(arr) -> int:
    """Devices holding distinct pieces of ``arr`` (0 if any shard holds the
    whole array, i.e. it is replicated rather than split)."""
    shards = arr.addressable_shards
    if any(s.data.size == arr.size for s in shards) and len(shards) > 1:
        return 0
    return len({s.device for s in shards})


def phase5(frame=(2160, 3840), side: int = 10980):
    """Sharded batch and plane paths on 4 cards, byte-identical to 1 card.

    The split checks look at what the entry points' own programs produce:
    the batch's coefficient levels and decoded planes, and the plane's
    levels and decoded rows must each be split over the 4 cards."""
    import jax
    from jpeg_tpu import Configuration, QuantizationMethod, entropy, parallel
    from jpeg_tpu.container import read_data
    from jpeg_tpu.ops import band as band_ops
    from jpeg_tpu.parallel import sharded
    from jpeg_tpu.utils.device import device_entropy_default
    from jpeg_tpu.utils.synth import synth_image
    devs = jax.devices()
    mesh4 = parallel.make_mesh(4, devices=devs[:4])
    mesh1 = parallel.make_mesh(1, devices=devs[:1])
    assert mesh4.devices.shape == (1, 4), mesh4.devices.shape
    f32 = np.dtype(np.float32)
    say(f"phase 5 mesh (data, band) = {mesh4.devices.shape}, entropy on "
        f"{'device' if device_entropy_default() else 'host'}")

    fh, fw = frame
    cfg = Configuration(width=fw, height=fh, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    frames = np.stack([synth_image(fh, fw, seed=40 + i) for i in range(4)])
    t0 = time.perf_counter()
    got = parallel.compress_batch(frames, cfg, mesh4)
    back = parallel.decompress_batch(got, mesh4)
    wall4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = parallel.compress_batch(frames, cfg, mesh1)
    back1 = parallel.decompress_batch(want, mesh1)
    wall1 = time.perf_counter() - t0
    assert got == want, "4-card batch containers differ from 1-card"
    np.testing.assert_array_equal(back, back1)
    bands = frames.transpose(0, 3, 1, 2).reshape(12, fh, fw)
    lv = sharded._batch_encode_fn(band_ops.config_key(cfg), f32.name, mesh4,
                                  bands.shape, with_stats=False)(bands)
    streams = [s for _, d in map(read_data, got) for s in (d.y, d.cb, d.cr)]
    planes = sharded._decompress_batch_device(streams, cfg, mesh4, 4, f32)
    for name, arr in (("batch levels", lv), ("batch planes", planes)):
        n = split_over(arr)
        assert n == 4, f"{name} split over {n} devices, not 4"
    say(f"phase 5 batch 4x{fh}x{fw}: 4 cards {wall4:.3f} s, 1 card "
        f"{wall1:.3f} s (compile included); containers and planes equal; "
        f"levels and planes split over 4 cards")

    pcfg = Configuration(width=side, height=side, block_size=2,
                         dct_size=8, quantization=QuantizationMethod("qtable"))
    plane = synth_image(side, side, channels=1, seed=50)[:, :, 0]
    t0 = time.perf_counter()
    s4 = parallel.compress_plane(plane, pcfg, mesh4)
    p4 = parallel.decompress_plane(s4, pcfg, mesh4)
    wall4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    s1 = parallel.compress_plane(plane, pcfg, mesh1)
    p1 = parallel.decompress_plane(s1, pcfg, mesh1)
    wall1 = time.perf_counter() - t0
    assert s4 == s1, "4-card plane stream differs from 1-card"
    np.testing.assert_array_equal(p4, p1)
    lv = sharded._plane_encode_fn(band_ops.config_key(pcfg), f32.name, mesh4,
                                  plane.shape)(plane)
    assert s4 == entropy.encode_levels(np.asarray(lv)[:pcfg.num_blocks]), \
        "4-card plane stream differs from the host C++ codec"
    rows = sharded._decode_plane_device(s4, pcfg, mesh4, f32)
    np.testing.assert_array_equal(np.asarray(rows), p4)
    for name, arr in (("plane levels", lv), ("plane rows", rows)):
        n = split_over(arr)
        assert n == 4, f"{name} split over {n} devices, not 4"
    say(f"phase 5 plane {side}x{side} ({pcfg.num_blocks} blocks, padded to "
        f"{lv.shape[0]}): 4 cards {wall4:.3f} s, 1 card {wall1:.3f} s "
        f"(compile included); stream and plane equal, {len(s4)} bytes, "
        f"equal to the host codec; levels and rows split over 4 cards")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    require_gpu(devices, 4 if args.four_cards else 1)
    from jpeg_tpu.utils.jit_cache import enable_persistent_cache
    enable_persistent_cache()
    from jpeg_tpu.entropy import native_codec
    from jpeg_tpu.utils.device import device_entropy_default
    assert native_codec.available(), "C++ entropy codec did not build"
    say(card_line())
    say(f"jax {jax.__version__}, {devices[0].device_kind} x{len(devices)}")
    say("entropy placement (encode and decode): "
        f"{'device' if device_entropy_default() else 'host'}; "
        "C++ codec built")
    t0 = time.perf_counter()
    if args.four_cards:
        phase5()
    else:
        blob, planes = phase1()
        phase2()
        phase3()
        phase4(blob, planes)
    say(f"total wall {time.perf_counter() - t0:.1f} s")
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
