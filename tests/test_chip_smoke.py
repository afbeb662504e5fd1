"""chip_smoke.py's pure helpers and its phases at tiny sizes on the CPU.

The script itself runs only on a GPU; here its checks are exercised on
small shapes so that a wrong path, argument or control flow shows before
a chip run."""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as C
from jpeg_tpu.entropy import device_codec as DC
from jpeg_tpu.entropy import numpy_codec as NC
from jpeg_tpu.utils import parity as PAR


def test_refuses_to_run_without_a_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        C.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_require_gpu_counts_cards():
    class Dev:
        platform = "gpu"
    C.require_gpu([Dev()], 1)
    with pytest.raises(SystemExit):
        C.require_gpu([Dev()], 4)
    with pytest.raises(SystemExit):
        C.require_gpu(jax.devices(), 1)


def test_fails_alone_in_an_empty_directory(tmp_path):
    shutil.copy(C.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_result_line_is_the_contract():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"
    line = C.result_line([Dev()] * 4)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_tie_counts_pass_and_fail():
    want = np.array([[3, 4], [5, 6]])
    ties = np.array([[False, True], [False, False]])
    got = want.copy()
    got[0, 1] += 1
    assert C.tie_counts(got, want, ties) == {"n": 4, "ties": 1, "flips": 1}
    got[1, 0] += 1                          # a flip away from any tie
    with pytest.raises(AssertionError):
        C.tie_counts(got, want, ties)
    assert C.add_counts({"n": 1, "ties": 2, "flips": 0},
                        {"n": 3, "ties": 0, "flips": 1}) == \
        {"n": 4, "ties": 2, "flips": 1}


def _loop_steps(levels):
    """Steps the device while_loop takes: it advances every block by one
    code unit per step until the last block reads its EOB, so walk each
    block's units in the host stream and take the longest."""
    n, L = levels.shape
    stream = NC.encode_levels(levels) + b"\0"
    longest = 0
    for s in NC.scan_offsets(stream[:-1], n, L):
        pos, units = 8 * int(s), 0
        while True:
            w = int.from_bytes(stream[pos >> 3:(pos >> 3) + 2].ljust(2, b"\0"),
                               "big")
            header = (w >> (8 - (pos & 7))) & 0xFF
            units += 1
            if header == 0:                 # EOB
                break
            pos += 8 if header == 0xF0 else 8 + (header & 0xF)
        longest = max(longest, units)
    return longest


@pytest.mark.parametrize("case", ["sparse", "dense", "long_runs", "empty"])
def test_decode_steps_counts_code_units(case):
    rng = np.random.default_rng(len(case))
    lv = np.zeros((40, 64), np.int32)
    if case == "sparse":
        m = rng.random(lv.shape) < 0.1
        lv[m] = rng.integers(-300, 300, int(m.sum()))
    elif case == "dense":
        lv[:] = rng.integers(1, 50, lv.shape)
    elif case == "long_runs":
        lv[3, 63] = 2                       # 4 chains + code + EOB = 6
        lv[5, 16] = -1                      # 1 chain + code + EOB = 3
    want = {"sparse": None, "dense": 65, "long_runs": 6, "empty": 1}[case]
    got = PAR.decode_steps(lv)
    if want is not None:
        assert got == want
    assert got == _loop_steps(lv)
    assert got <= 64 + 64 // DC.MAX_RUN + 2


def test_dot_precision_findings():
    ok = ("%dot.1 = f32[64,64]{1,0} dot(f32[64,16] %a, f32[16,64] %b), "
          "lhs_contracting_dims={1}, rhs_contracting_dims={0}, "
          "operand_precision={highest,highest}")
    tf32 = ('%gemm = (f32[64,64], s8[0]) custom-call(%a, %b), custom_call_'
            'target="__cublas$gemm", backend_config={"algorithm":'
            '"ALG_DOT_TF32_TF32_F32"}')
    bf16x3 = ("%dot.2 = f32[8,8] dot(%a, %b), algorithm="
              "dot_bf16_bf16_f32_x3")
    low = ("%dot.3 = f32[8,8] dot(%a, %b), lhs_contracting_dims={1}, "
           "rhs_contracting_dims={0}, operand_precision={default,default}")
    text = "\n".join([ok, tf32, bf16x3, low, "%add = f32[8] add(%x, %y)"])
    found = C.dot_precision_findings(text)
    assert len(found) == 3 and not any("dot.1" in f for f in found)
    assert C.count_dots(ok + "\n" + tf32) == 2


def test_split_over_tells_split_from_replicated():
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("band",))
    x = np.zeros((8, 4), np.int32)
    assert C.split_over(jax.device_put(x, NamedSharding(mesh, P("band")))) == 4
    assert C.split_over(jax.device_put(x, NamedSharding(mesh, P()))) == 0


def test_phase1_and_4_at_tiny_size(capsys):
    blob, planes = C.phase1(n=64, min_psnr=20.0)
    C.phase4(blob, planes)
    out = capsys.readouterr().out
    assert "phase 1 main" in out and "planes equal phase 1" in out
    assert "JPEG_TPU_SCAN" not in os.environ


def test_phase2_and_3_at_tiny_size(capsys):
    C.phase2(h=48, w=64)
    C.phase3(n=96)
    out = capsys.readouterr().out
    for name in ("2 photo-12MP", "3a", "3b", "3c", "3d"):
        assert f"phase {name}" in out


def test_phase5_at_tiny_size(capsys):
    C.phase5(frame=(64, 64), side=80)     # side 80: 25 blocks pad to 28
    out = capsys.readouterr().out
    assert "containers and planes equal" in out
    assert "stream and plane equal" in out
