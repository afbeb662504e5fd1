"""Platform policy: where entropy coding runs, and where compiles cache."""
import os

import jax
import pytest

from jpeg_tpu.utils import device as D
from jpeg_tpu.utils import jit_cache


@pytest.mark.parametrize("platform,want", [
    ("gpu", True),               # measured on an H100: device wins both ways
    ("cpu", False),              # the host C++ codec everywhere else
    ("rocm", False),             # an unmeasured platform keeps the host
    ("METAL", False),
    ("", False),
    ("Gpu", False),              # JAX's platform names are lower case
])
def test_entropy_placement_per_platform(platform, want):
    assert D.device_entropy_default(platform=platform) is want


def test_entropy_placement_defaults_to_the_backend():
    assert D.device_entropy_default() is D.device_entropy_default(
        platform=jax.default_backend())
    assert jax.default_backend() == "cpu"
    assert not D.device_entropy_default()


def test_api_asks_the_one_policy(monkeypatch):
    from jpeg_tpu import api
    seen = []
    monkeypatch.setattr(D, "device_entropy_default",
                        lambda: seen.append(1) or False)
    assert api._use_device_entropy() is False
    assert api._use_device_entropy() is False
    assert seen == [1, 1]


@pytest.mark.parametrize("entry", ["compress_batch", "decompress_batch",
                                   "compress_plane", "decompress_plane"])
def test_sharded_entry_points_ask_the_one_policy(monkeypatch, entry):
    """Each sharded entry point, given no ``device_entropy``, takes the
    placement from the policy (here forced to the device on the CPU)."""
    import numpy as np
    from jpeg_tpu import Configuration, QuantizationMethod, parallel
    from jpeg_tpu.parallel import sharded
    monkeypatch.setattr(D, "device_entropy_default", lambda: True)
    cfg = Configuration(width=16, height=16, block_size=2, dct_size=8,
                        quantization=QuantizationMethod("qtable"))
    mesh = parallel.make_mesh(2)
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    plane = imgs[0, :, :, 0].astype(np.int32)
    blobs = parallel.compress_batch(imgs, cfg, mesh, device_entropy=False)
    stream = parallel.compress_plane(plane, cfg, mesh, device_entropy=False)
    seen = []
    for name in ("_batch_stream_fn", "_decompress_batch_device",
                 "_plane_entropy_fn", "_decode_plane_device"):
        real = getattr(sharded, name)
        monkeypatch.setattr(sharded, name,
                            lambda *a, _r=real, _n=name, **k:
                            seen.append(_n) or _r(*a, **k))
    args = {"compress_batch": (imgs, cfg, mesh),
            "decompress_batch": (blobs, mesh),
            "compress_plane": (plane, cfg, mesh),
            "decompress_plane": (stream, cfg, mesh)}[entry]
    getattr(parallel, entry)(*args)
    want = {"compress_batch": "_batch_stream_fn",
            "decompress_batch": "_decompress_batch_device",
            "compress_plane": "_plane_entropy_fn",
            "decompress_plane": "_decode_plane_device"}[entry]
    assert seen == [want]


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_follows_env(monkeypatch, tmp_path,
                                   restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    assert jit_cache.cache_dir() == str(tmp_path)
    jit_cache.enable_persistent_cache()
    # the directory JAX took from the environment is left as it is
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_into_checkout(monkeypatch,
                                              restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(jit_cache.REPO_ROOT, ".jax_cache")
    assert jit_cache.cache_dir() == want
    jit_cache.enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)
    # fixed, inside the checkout, and kept out of git
    assert os.path.isfile(os.path.join(jit_cache.REPO_ROOT, "jpeg_tpu",
                                       "__init__.py"))
    with open(os.path.join(jit_cache.REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_native_codec_builds_into_checkout():
    from jpeg_tpu.entropy import native_codec
    so = native_codec._so_path()
    assert os.path.dirname(so) == os.path.join(jit_cache.REPO_ROOT, "build")
    # the entropy layer does not lean on the compile-cache module for it
    with open(native_codec.__file__) as f:
        assert "jit_cache" not in f.read()
