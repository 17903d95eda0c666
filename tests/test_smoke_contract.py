"""What chip_smoke.py and bench.py promise on a machine without a GPU, and
the compile-cache placement they share."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_raises_on_cpu():
    from zuds_tpu.env import require_gpu
    with pytest.raises(RuntimeError, match='needs a GPU'):
        require_gpu()


def test_smoke_device_phase_raises_on_cpu(monkeypatch):
    """Even with a card query that answers, a CPU backend stops phase 0."""
    sys.path.insert(0, REPO)
    import chip_smoke
    import zuds_tpu.env as env
    monkeypatch.setattr(env, 'query_cards', lambda: 'NVIDIA H100, 700 W')
    monkeypatch.setattr(env, 'enable_compile_cache', lambda: 'unused')
    with pytest.raises(RuntimeError, match='needs a GPU'):
        chip_smoke.phase_device()


@pytest.mark.parametrize('script', ['chip_smoke.py', 'bench.py'])
def test_script_fails_without_gpu(script, tmp_path):
    """No GPU: a non-zero exit and no result line, never a CPU number."""
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               ZUDS_CONFIG=str(tmp_path / 'cfg.yaml'))
    proc = subprocess.run([sys.executable, os.path.join(REPO, script)],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert '"value"' not in proc.stdout


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    import jax
    from zuds_tpu.env import enable_compile_cache
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_fixed_repo_path(monkeypatch):
    import jax
    from zuds_tpu.env import COMPILE_CACHE_DIR, enable_compile_cache
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    try:
        assert enable_compile_cache() == COMPILE_CACHE_DIR
        assert COMPILE_CACHE_DIR == os.path.join(REPO, '.jax_cache')
        assert jax.config.jax_compilation_cache_dir == COMPILE_CACHE_DIR
    finally:
        jax.config.update('jax_compilation_cache_dir', None)
