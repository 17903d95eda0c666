"""Work distribution across hosts/chips (reference: zuds/mpi.py).

The reference scatters a file list over MPI ranks + slurm array tasks
(``zuds/mpi.py:36-64``); communication is scatter + barrier only. The
device-native equivalent keeps the identical file-list semantics but derives
(rank, size) from, in priority order: ``jax.distributed`` process info when
initialized, MPI via mpi4py when launched under mpirun, else slurm env vars,
else single-process. Device-level parallelism lives in
``zuds_tpu.parallel`` (sharded batches over the chip mesh) — host ranks and
chip shards compose.
"""
from __future__ import annotations

import math
import os

import numpy as np

__all__ = ['get_my_share_of_work', 'get_nthreads', 'has_mpi', 'rank_info',
           'barrier']


def has_mpi():
    try:
        from mpi4py import MPI  # noqa
        return True
    except ImportError:
        return False


def rank_info():
    """(rank, size) of this worker process."""
    try:
        import jax
        if jax.process_count() > 1:
            return jax.process_index(), jax.process_count()
    except Exception:
        pass
    if has_mpi():
        from mpi4py import MPI
        comm = MPI.COMM_WORLD
        return comm.Get_rank(), comm.Get_size()
    if 'SLURM_PROCID' in os.environ:
        return (int(os.environ['SLURM_PROCID']),
                int(os.environ.get('SLURM_NTASKS', 1)))
    return 0, 1


def barrier():
    if has_mpi():
        from mpi4py import MPI
        MPI.COMM_WORLD.Barrier()


def get_nthreads():
    """Threads available to this rank (reference: zuds/mpi.py:15-25)."""
    from .constants import NTHREADS_PER_NODE
    if 'SLURM_CPUS_PER_TASK' in os.environ:
        return int(os.environ['SLURM_CPUS_PER_TASK'])
    return NTHREADS_PER_NODE


def get_my_share_of_work(fname, reader=None):
    """This rank's slice of the work list in ``fname``.

    Composes, like the reference (zuds/mpi.py:36-64):
    1. slurm job-array splitting (SLURM_ARRAY_TASK_ID over TASK_MAX),
    2. rank splitting (jax.distributed / MPI / SLURM_PROCID),
    degrading gracefully to the whole list in a single process.
    """
    if reader is None:
        def reader(f):
            with open(f) as fh:
                return np.asarray([line.strip() for line in fh
                                   if line.strip()])
    work = np.atleast_1d(reader(fname))

    array_id = os.getenv('SLURM_ARRAY_TASK_ID')
    if array_id is not None:
        ntask = int(os.environ.get('SLURM_ARRAY_TASK_MAX', 0)) + 1
        work = np.array_split(work, ntask)[int(array_id)]

    rank, size = rank_info()
    if size > 1:
        work = np.array_split(work, size)[rank]
    return work
