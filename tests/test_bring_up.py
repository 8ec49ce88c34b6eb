"""What decides where the program runs: the compile-cache directory, the
refusal to measure without a GPU, and the single-process default of the
distributed bootstrap."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from gptools_tpu.parallel import distributed
from gptools_tpu.utils import device, xla_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    keys = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes",
    )
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_cache_dir_from_environment(tmp_path, monkeypatch, restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it and the program sets
    no directory of its own."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "/untouched")
    assert xla_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "/untouched"


def test_cache_dir_default_is_the_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = xla_cache.enable()
    assert path == os.path.join(ROOT, ".xla_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def test_require_gpu_refuses_the_cpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        device.require_gpu()


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_a_gpu():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_chip_smoke_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("env", [{}, {"SLURM_JOB_NODELIST": "h0,h1"}])
def test_initialize_stays_single_process(monkeypatch, env):
    """No coordinator named: initialize() is a no-op (other cluster markers
    do not start a process group)."""
    for k in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    distributed.initialize()
    from jax._src import distributed as _jd

    assert not _jd.is_initialized()
    assert jax.process_count() == 1
    assert not distributed.is_multiprocess()
