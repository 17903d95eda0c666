"""Test bootstrap: run JAX on a virtual 8-device CPU mesh.

The CPU tests need no card: sharding tests run against
``--xla_force_host_platform_device_count=8``. This must run before JAX
picks its backend. ``JAX_PLATFORMS`` is honoured when it is set, so the
tests marked ``gpu`` can run on a machine with a card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

Whether a card is there is decided inside the ``gpu_device`` fixture,
never while a test module is imported.
"""
import os
import tempfile

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

# synchronous dispatch on the CPU backend: async dispatch intermittently
# segfaults when shard_map programs over the 8 virtual devices run late in
# the suite (observed in jax 0.9.0; cost is negligible at test scale)
try:
    jax.config.update('jax_cpu_enable_async_dispatch', False)
except AttributeError:
    pass
# keep test config away from the user's real one
os.environ.setdefault('ZUDS_CONFIG', os.path.join(
    tempfile.gettempdir(), 'zuds-tpu-test-config.yaml'))
# no persistent compile cache in the tests: each test compiles what it
# runs, so a stale or foreign cache entry can never stand in for the code
jax.config.update('jax_compilation_cache_dir', None)

import numpy as np
import pytest


@pytest.fixture()
def rng():
    # function-scoped: every test gets the same fresh stream regardless of
    # execution order (a shared session rng made tests order-dependent)
    return np.random.default_rng(8675309)


@pytest.fixture()
def tmp_config(tmp_path, monkeypatch):
    """Point the secrets manager at a fresh config in tmp_path."""
    import zuds_tpu.secrets as secrets
    cfg = tmp_path / 'config.yaml'
    monkeypatch.setenv('ZUDS_CONFIG', str(cfg))
    secrets._manager.cache = None
    yield cfg
    secrets._manager.cache = None


@pytest.fixture()
def gpu_device():
    """The first GPU, or a skip when JAX has none (tests marked gpu)."""
    gpus = [d for d in jax.devices() if d.platform == 'gpu']
    if not gpus:
        pytest.skip('needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest '
                    '-m gpu tests/')
    return gpus[0]
