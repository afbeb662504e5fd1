"""REAL 2-process multihost execution.

Spawns two coordinated processes (jax.distributed over localhost DCN, 4
virtual CPU devices each = 8 global) and asserts the distributed row-band
stitch produces byte-identical streams to the serial encoder — covering the
``jax.process_count() > 1`` branches of parallel/multihost.py (host-local
shard contiguity, the process_allgather stitch, and the replicated-levels
dedup) that single-process tests cannot reach.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(nproc, outdir, port):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_NUM_CPU_DEVICES", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_multihost_child.py"),
             f"127.0.0.1:{port}", str(nproc), str(pid), outdir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return procs, outs


def test_two_process_distributed_stitch(tmp_path):
    nproc = 2
    procs, outs = _spawn(nproc, str(tmp_path), _free_port())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"child {p.args[-2]} failed:\n{out}"

    from jpeg_tpu import api
    from jpeg_tpu.config import Configuration, QuantizationMethod
    sys.path.insert(0, HERE)
    from _multihost_child import synth_plane

    for name, (h, w) in [("sharded", (128, 128)), ("replicated", (64, 48))]:
        cfg = Configuration(width=w, height=h, block_size=2, dct_size=8,
                            quantization=QuantizationMethod("qtable"))
        want = api.compress_band(synth_plane(h, w), cfg)
        streams = []
        for pid in range(nproc):
            path = tmp_path / f"stream_{name}_{pid}.bin"
            assert path.exists(), f"missing output from child {pid}"
            streams.append(path.read_bytes())
        # every process materializes the identical stitched stream,
        # byte-equal to the serial single-device encode
        assert streams[0] == streams[1], f"{name}: processes disagree"
        assert streams[0] == want, f"{name}: stitched != serial bytes"

        # decode dual: each process's host-local rows reassemble into the
        # serial decoder's plane byte-for-byte
        want_plane = api.decompress_band(want, cfg)
        rows = [np.load(tmp_path / f"rows_{name}_{pid}.npy")
                for pid in range(nproc)]
        if rows[0].shape[0] == want_plane.shape[0]:
            # geometry forced replication: every host returns the plane
            for r in rows:
                np.testing.assert_array_equal(r, want_plane)
        else:
            got = np.concatenate(rows, axis=0)
            np.testing.assert_array_equal(got, want_plane), name

    # Batch phase (BASELINE config 5's shape): per-host image ownership,
    # manifest-only DCN traffic; blobs byte-equal the serial encoder.
    from _multihost_child import synth_image
    bh, bw = 40, 56
    bcfg = Configuration(width=bw, height=bh, block_size=2, dct_size=8,
                         quantization=QuantizationMethod("qtable"))
    manifests = [np.load(tmp_path / f"manifest_{pid}.npy")
                 for pid in range(nproc)]
    np.testing.assert_array_equal(manifests[0], manifests[1])
    for i in range(5):
        want_blob = api.compress_ycbcr(synth_image(bh, bw, i), bcfg)
        got = (tmp_path / f"batch_{i}.bin").read_bytes()
        assert got == want_blob, f"batch image {i} differs from serial"
        assert manifests[0][i, 0] == len(want_blob)
        assert manifests[0][i, 1] == 1
        assert manifests[0][i, 2] > 20000          # PSNR > 20 dB (milli-dB)


@pytest.mark.skipif(os.environ.get("JPEG_TPU_SLOW_TESTS") != "1",
                    reason="4-process spawn is slow; JPEG_TPU_SLOW_TESTS=1")
def test_four_process_distributed_stitch(tmp_path):
    """nproc=4 (16 virtual devices): same assertions as the 2-process case
    for the plane stitch and the batch driver."""
    nproc = 4
    procs, outs = _spawn(nproc, str(tmp_path), _free_port())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"child {p.args[-2]} failed:\n{out}"

    from jpeg_tpu import api
    from jpeg_tpu.config import Configuration, QuantizationMethod
    sys.path.insert(0, HERE)
    from _multihost_child import synth_plane, synth_image

    h, w = 128, 128
    cfg = Configuration(width=w, height=h, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    want = api.compress_band(synth_plane(h, w), cfg)
    streams = [(tmp_path / f"stream_sharded_{pid}.bin").read_bytes()
               for pid in range(nproc)]
    assert all(s == want for s in streams)

    manifests = [np.load(tmp_path / f"manifest_{pid}.npy")
                 for pid in range(nproc)]
    bh, bw = 40, 56
    bcfg = Configuration(width=bw, height=bh, block_size=2, dct_size=8,
                         quantization=QuantizationMethod("qtable"))
    for m in manifests[1:]:
        np.testing.assert_array_equal(manifests[0], m)
    for i in range(5):
        want_blob = api.compress_ycbcr(synth_image(bh, bw, i), bcfg)
        assert (tmp_path / f"batch_{i}.bin").read_bytes() == want_blob
