"""Process identity for sharded reads: :func:`distributed_shard_info`, the
counterpart of ``petastorm_tpu.parallel.mesh.distributed_shard_info`` with
``torch.distributed`` in place of JAX's process index and count. Meshes and
batch shardings wait for the distributed slice."""

import os

#: explicit process identity, the same variable names the JAX package's
#: topology plane reads (copied here, not imported)
PROCESS_INDEX_ENV = 'PETASTORM_TPU_PROCESS_INDEX'
PROCESS_COUNT_ENV = 'PETASTORM_TPU_PROCESS_COUNT'


def distributed_shard_info(cur_shard=None, shard_count=None):
    """This process's ``(cur_shard, shard_count)`` for reader construction.

    Priority: explicit arguments > the ``PETASTORM_TPU_PROCESS_INDEX``/``_COUNT``
    pair > an initialized ``torch.distributed`` with more than one rank
    (``get_rank()``, ``get_world_size()``) > Horovod and MPI environment
    variables > ``(None, None)`` (one process, no sharding)."""
    if cur_shard is not None or shard_count is not None:
        if (cur_shard is None) != (shard_count is None):
            raise ValueError('cur_shard and shard_count must be given together')
        return cur_shard, shard_count
    if PROCESS_INDEX_ENV in os.environ and PROCESS_COUNT_ENV in os.environ:
        return int(os.environ[PROCESS_INDEX_ENV]), int(os.environ[PROCESS_COUNT_ENV])
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    for rank_var, size_var in (('HOROVOD_RANK', 'HOROVOD_SIZE'),
                               ('OMPI_COMM_WORLD_RANK', 'OMPI_COMM_WORLD_SIZE'),
                               ('PMI_RANK', 'PMI_SIZE')):
        if rank_var in os.environ and size_var in os.environ:
            return int(os.environ[rank_var]), int(os.environ[size_var])
    return None, None
