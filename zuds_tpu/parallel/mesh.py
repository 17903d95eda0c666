"""Device mesh + sharding helpers.

The reference's parallelism is file-list data parallelism over MPI ranks
(SURVEY §2.3); the device-native equivalent shards *batches of quadrants* over
the chip mesh: axis ``data`` carries independent quadrants (embarrassingly
parallel, like the reference's ranks), axis ``space`` optionally shards
image rows of very large frames (full-CCD mosaics) with XLA inserting halo
exchanges. Multi-host nights initialize ``jax.distributed`` and use the same
mesh spanning all processes.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ['quadrant_mesh', 'batch_sharding', 'shard_batch',
           'init_distributed', 'P', 'NamedSharding']


def quadrant_mesh(n_data=None, n_space=1, devices=None):
    """Mesh with ('data', 'space') axes over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_data is None:
        n_data = n // n_space
    assert n_data * n_space == n, (n_data, n_space, n)
    arr = np.asarray(devices).reshape(n_data, n_space)
    return Mesh(arr, ('data', 'space'))


def batch_sharding(mesh, space_dim=None):
    """Sharding for (B, H, W) stacks: batch over 'data', rows optionally
    over 'space'."""
    if space_dim is None:
        return NamedSharding(mesh, P('data'))
    spec = [None, None, None]
    spec[0] = 'data'
    spec[space_dim] = 'space'
    return NamedSharding(mesh, P(*spec))


def shard_batch(mesh, *arrays, space=False):
    """Device-put (B, ...) arrays with batch sharded over 'data'."""
    out = []
    for a in arrays:
        spec = ['data'] + [None] * (a.ndim - 1)
        if space and a.ndim >= 3:
            spec[1] = 'space'
        out.append(jax.device_put(a, NamedSharding(mesh, P(*spec))))
    return out if len(out) > 1 else out[0]


def init_distributed():
    """Initialize jax.distributed from slurm/env when running multi-host
    (no-op single-host)."""
    import os
    if 'SLURM_NTASKS' in os.environ and int(os.environ['SLURM_NTASKS']) > 1:
        jax.distributed.initialize()
    return jax.process_index(), jax.process_count()
