"""Batch driver: compress/decompress a directory of images with metrics.

The reference has no batch mode, no failure handling and no observability
(SURVEY.md §5).  This driver adds the minimum production surface:

* **Resume**: an image whose output file already exists is skipped, so an
  interrupted job re-run picks up where it left off.
* **Failure detection**: unreadable/corrupt inputs are skipped and reported
  (exit code 1 if anything failed) instead of aborting the whole job.
* **Metrics**: one JSON line per run — megapixels/s, compressed bytes,
  compression ratio, failures, optional mean PSNR (with --verify the driver
  decodes each output and scores it against the input).
* **Grouped dispatch**: same-size images are batched through the sharded
  mesh path (jpeg_tpu.parallel) so the device sees large block batches.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api import decompress_to_ycbcr, psnr
from ..config import Configuration
from ..utils.profiling import Metrics
from .compress import quantization_from_args

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tiff", ".webp"}


def _load_ycbcr(path: str) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("YCbCr"))


def _group_by_size(paths: List[str]) -> Tuple[Dict[Tuple[int, int], List[str]],
                                              Dict[str, str]]:
    """Probe image headers; group readable files by (H, W)."""
    from PIL import Image
    groups: Dict[Tuple[int, int], List[str]] = {}
    errors: Dict[str, str] = {}
    for p in paths:
        try:
            with Image.open(p) as im:
                key = (im.height, im.width)
        except Exception as e:  # noqa: BLE001
            errors[p] = f"unreadable: {e}"
            continue
        groups.setdefault(key, []).append(p)
    return groups, errors


def run(indir: str, outdir: str, args, mesh=None) -> Metrics:
    os.makedirs(outdir, exist_ok=True)
    paths = sorted(
        os.path.join(indir, f) for f in os.listdir(indir)
        if os.path.splitext(f)[1].lower() in IMAGE_EXTS)
    metrics = Metrics()
    quant = quantization_from_args(args)

    groups, errors = _group_by_size(paths)
    for p, why in errors.items():
        print(f"SKIP {p}: {why}", file=sys.stderr)
        metrics.failures += 1

    for (h, w), members in sorted(groups.items()):
        config = Configuration(width=w, height=h, block_size=args.block_size,
                               dct_size=args.dct_size,
                               transform=args.transform, quantization=quant)
        pending = []
        for p in members:
            out = os.path.join(
                outdir, os.path.splitext(os.path.basename(p))[0] + ".jc")
            if os.path.exists(out) and not args.force:
                print(f"RESUME-SKIP {out} exists", file=sys.stderr)
                continue
            pending.append((p, out))
        if not pending:
            continue

        arrays, items = [], []
        for p, out in pending:
            try:
                arrays.append(_load_ycbcr(p))
                items.append((p, out))
            except Exception as e:  # noqa: BLE001
                print(f"SKIP {p}: decode failed: {e}", file=sys.stderr)
                metrics.failures += 1

        t0 = time.perf_counter()
        if mesh is not None and len(arrays) > 1:
            from .. import parallel
            blobs = parallel.compress_batch(
                np.stack(arrays), config, mesh)
        else:
            # Pipelined: image i+1 uploads/transforms while image i's
            # compressed bytes stream back (api.compress_many).
            from ..api import compress_many
            blobs = compress_many(arrays, config)
        dt = time.perf_counter() - t0

        for (p, out), arr, blob in zip(items, arrays, blobs):
            with open(out, "wb") as f:
                f.write(blob)
            q = None
            if args.verify:
                q = psnr(arr, decompress_to_ycbcr(blob))
            metrics.add_image(h, w, len(blob), dt / max(1, len(items)), q)
            if args.verbose:
                print(f"OK {p} -> {out} ({len(blob)} bytes)", file=sys.stderr)
    return metrics


def run_distributed(indir: str, outdir: str, args) -> Metrics:
    """Multi-host DP batch encode (BASELINE config 5's shape): process p
    owns the pending images with index % nproc == p, encodes them on its
    own devices, and writes only its own outputs; per-image byte counts
    cross DCN as a manifest so every host reports identical global metrics
    (parallel/multihost.py:compress_batch_distributed).

    Assumes every process sees the same ``indir`` listing and output
    existence (shared filesystem, or rsync'd replicas) — ownership is
    derived from the shared pending order.
    """
    import jax
    from ..parallel import multihost

    os.makedirs(outdir, exist_ok=True)
    paths = sorted(
        os.path.join(indir, f) for f in os.listdir(indir)
        if os.path.splitext(f)[1].lower() in IMAGE_EXTS)
    metrics = Metrics()
    quant = quantization_from_args(args)
    pid, nproc = jax.process_index(), jax.process_count()

    groups, errors = _group_by_size(paths)
    for p, why in errors.items():
        print(f"SKIP {p}: {why}", file=sys.stderr)
    metrics.failures += len(errors)

    for (h, w), members in sorted(groups.items()):
        config = Configuration(width=w, height=h, block_size=args.block_size,
                               dct_size=args.dct_size,
                               transform=args.transform, quantization=quant)
        pending = []
        for p in members:
            out = os.path.join(
                outdir, os.path.splitext(os.path.basename(p))[0] + ".jc")
            if os.path.exists(out) and not args.force:
                if pid == 0:
                    print(f"RESUME-SKIP {out} exists", file=sys.stderr)
                continue
            pending.append((p, out))
        if not pending:
            continue

        t0 = time.perf_counter()
        loaders = [(lambda q=p: _load_ycbcr(q)) for p, _ in pending]
        blobs, manifest = multihost.compress_batch_distributed(
            loaders, config, verify=args.verify)
        dt = time.perf_counter() - t0

        n_ok = int(manifest[:, 1].sum())
        for i, ((p, out), blob) in enumerate(zip(pending, blobs)):
            if blob is not None:
                with open(out, "wb") as f:
                    f.write(blob)
                if args.verbose:
                    print(f"OK {p} -> {out} ({len(blob)} bytes)",
                          file=sys.stderr)
            if manifest[i, 1]:
                q = manifest[i, 2] / 1000 if manifest[i, 2] >= 0 else None
                metrics.add_image(h, w, int(manifest[i, 0]),
                                  dt / max(1, n_ok), q)
            else:
                metrics.failures += 1
    return metrics


def run_decompress(indir: str, outdir: str, args) -> Metrics:
    """Batch decode: .jc containers -> .png, resumable and skip-and-report.

    Decode is pipelined (api.decompress_many): blob i+1's host scan and
    device bit-parse overlap blob i's plane download and PNG write.
    """
    from ..api import decompress_many
    os.makedirs(outdir, exist_ok=True)
    paths = sorted(os.path.join(indir, f) for f in os.listdir(indir)
                   if f.endswith(".jc"))
    metrics = Metrics()
    pending: List[Tuple[str, str]] = []
    for p in paths:
        out = os.path.join(
            outdir, os.path.splitext(os.path.basename(p))[0] + ".png")
        if os.path.exists(out) and not args.force:
            print(f"RESUME-SKIP {out} exists", file=sys.stderr)
            continue
        pending.append((p, out))

    blobs, items = [], []
    for p, out in pending:
        try:
            with open(p, "rb") as f:
                blobs.append(f.read())
            items.append((p, out))
        except OSError as e:
            print(f"SKIP {p}: unreadable: {e}", file=sys.stderr)
            metrics.failures += 1

    from PIL import Image

    # A corrupt blob must not abort the batch, but restarting per-blob
    # would re-decode every good blob serially.  Bisect instead: a failing
    # group splits in half, so one bad blob costs O(log n) extra pipelined
    # passes and every good blob keeps the pipelining.
    def _decode_group(group_blobs, group_items):
        try:
            return decompress_many(group_blobs)
        except Exception as e:  # noqa: BLE001
            if len(group_blobs) == 1:
                p = group_items[0][0]
                print(f"SKIP {p}: corrupt container: {e}", file=sys.stderr)
                metrics.failures += 1
                return [None]
            mid = len(group_blobs) // 2
            return (_decode_group(group_blobs[:mid], group_items[:mid])
                    + _decode_group(group_blobs[mid:], group_items[mid:]))

    t0 = time.perf_counter()
    imgs = _decode_group(blobs, items)
    dt = time.perf_counter() - t0
    n_ok = sum(1 for im in imgs if im is not None)
    for (p, out), arr in zip(items, imgs):
        if arr is None:
            continue
        Image.fromarray(arr, "YCbCr").convert("RGB").save(out)
        metrics.add_image(arr.shape[0], arr.shape[1],
                          os.path.getsize(p), dt / max(1, n_ok), None)
        if args.verbose:
            print(f"OK {p} -> {out}", file=sys.stderr)
    return metrics


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Batch-compress (or --decompress) a directory, resumable")
    p.add_argument("indir")
    p.add_argument("outdir")
    p.add_argument("--block_size", type=int, default=4)
    p.add_argument("--dct_size", type=int, default=8)
    p.add_argument("--transform", type=str, default="DCT")
    p.add_argument("--quantization", type=str, default="qtable")
    p.add_argument("--qkeep", type=int, default=2)
    p.add_argument("--qdivisor", type=int, default=40)
    p.add_argument("--force", action="store_true",
                   help="recompress even if output exists")
    p.add_argument("--verify", action="store_true",
                   help="decode each output and report PSNR")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--mesh", action="store_true",
                   help="batch same-size images through the device mesh")
    p.add_argument("--decompress", action="store_true",
                   help="decode .jc containers back to .png instead")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host DP over the image set: run one process "
                        "per host with --coordinator/--nproc/--procid; "
                        "process p encodes images with index %% nproc == p")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of process 0 (jax.distributed)")
    p.add_argument("--nproc", type=int, default=None)
    p.add_argument("--procid", type=int, default=None)
    return p


def main(argv=None) -> int:
    from ..utils.jit_cache import enable_persistent_cache
    enable_persistent_cache()
    args = build_parser().parse_args(argv)
    if args.distributed:
        from ..parallel import multihost
        multihost.initialize(args.coordinator, args.nproc, args.procid)
        metrics = run_distributed(args.indir, args.outdir, args)
        print(metrics.json_line())
        return 1 if metrics.failures else 0
    if args.decompress:
        metrics = run_decompress(args.indir, args.outdir, args)
        print(metrics.json_line())
        return 1 if metrics.failures else 0
    mesh = None
    if args.mesh:
        from .. import parallel
        mesh = parallel.make_mesh()
    metrics = run(args.indir, args.outdir, args, mesh=mesh)
    print(metrics.json_line())
    return 1 if metrics.failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
