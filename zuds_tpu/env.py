"""Runtime environment checks (reference: zuds/env.py).

The reference verifies external binary versions (sex/swarp/hotpants/scamp/
psql) at import; this framework has no subprocess dependencies, so the
check inventories the compute backend instead: JAX version, device platform,
device count, and the optional native extension. It also places JAX's
persistent compilation cache (:func:`enable_compile_cache`).
"""
from __future__ import annotations

import os

__all__ = ['check_dependencies', 'DEPENDENCIES', 'enable_compile_cache',
           'COMPILE_CACHE_DIR', 'require_gpu', 'query_cards']

DEPENDENCIES = ('jax', 'optax', 'numpy')

# fixed, in the checkout (listed in .gitignore): the cache key includes
# the path, so a directory named per run would never hit
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    '.jax_cache')


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins and JAX reads it itself,
    so nothing is set here. Otherwise the cache goes to the fixed
    ``<repo>/.jax_cache``. Call before the first compile.
    """
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    import jax
    jax.config.update('jax_compilation_cache_dir', COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR


def check_dependencies(deps=DEPENDENCIES, verbose=False):
    """Verify importability of the python stack; returns an info dict."""
    import importlib
    info = {}
    missing = []
    for name in deps:
        try:
            mod = importlib.import_module(name)
            info[name] = getattr(mod, '__version__', 'unknown')
        except ImportError:
            missing.append(name)
    if missing:
        raise ImportError(f'missing required dependencies: {missing}')
    if verbose:
        import jax
        info['backend'] = jax.default_backend()
        info['devices'] = [str(d) for d in jax.devices()]
        print(info)
    return info


def query_cards():
    """The cards' names and power limits, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them. Runs no JAX, so it can be called before JAX opens a
    card. Raises when ``nvidia-smi`` is missing or fails."""
    import subprocess
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu():
    """JAX's devices, after checking that they are GPUs.

    Measurement and smoke paths call this so that a run on any other
    platform fails instead of falling back to the CPU."""
    import jax
    devices = jax.devices()
    if devices[0].platform != 'gpu':
        raise RuntimeError(
            f'this needs a GPU; JAX found platform '
            f'{devices[0].platform!r} ({devices[0].device_kind})')
    return devices
