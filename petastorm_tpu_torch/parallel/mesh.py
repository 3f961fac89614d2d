"""Process identity and device meshes over ``torch.distributed``.

- :func:`distributed_shard_info`, the counterpart of
  ``petastorm_tpu.parallel.mesh.distributed_shard_info`` with
  ``torch.distributed`` in place of JAX's process index and count.
- :func:`make_mesh`, the counterpart of ``petastorm_tpu.parallel.mesh.make_mesh``:
  a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
  initialised default group, whose named dimensions give the process groups
  of the model-side parallel ops (``mesh.get_group('expert')`` for
  :mod:`~petastorm_tpu_torch.ops.sharded_moe`, ``mesh.get_group('seq')`` for
  :mod:`~petastorm_tpu_torch.ops.ring_attention`). Ranks fill the mesh in
  row-major order, so within each dimension's group the group rank is the
  index along that dimension: the order ``all_to_all_single`` splits in.
- :func:`process_group`: the group such an op runs over, given a group or a
  one-dimensional ``DeviceMesh``.

``batch_sharding`` and the loader's partition specs come with the loader's
mesh path.
"""

import math
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


def make_mesh(axis_names=('data',), axis_sizes=None, device=None):
    """A ``DeviceMesh`` over the ranks of the initialised default process
    group, with dimensions ``axis_names`` of ``axis_sizes``.

    ``axis_sizes`` None gives one dimension over every rank, or the leading
    dimension every rank and the others 1, as in the JAX package. Sizes that
    do not multiply to the world size raise ``ValueError``. The mesh is on
    CUDA unless ``device='cpu'`` (the ``gloo`` backend)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from petastorm_tpu_torch.parallel.loader import resolve_device
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError('make_mesh needs an initialised torch.distributed process group '
                           '(torch.distributed.init_process_group)')
    device = resolve_device(device)
    n = dist.get_world_size()
    axis_names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    axis_sizes = tuple(int(size) for size in axis_sizes)
    if len(axis_sizes) != len(axis_names):
        raise ValueError('axis_sizes {} and axis_names {} differ in length'.format(
            axis_sizes, axis_names))
    if math.prod(axis_sizes) != n:
        raise ValueError('axis_sizes {} do not multiply to device count {}'.format(
            axis_sizes, n))
    return init_device_mesh(device.type, axis_sizes, mesh_dim_names=axis_names)


def process_group(group):
    """The ``ProcessGroup`` of ``group``: a group as it is, or a
    one-dimensional ``DeviceMesh`` (such as ``mesh['expert']``) as its
    group."""
    if hasattr(group, 'get_group'):
        if group.ndim != 1:
            raise ValueError('a DeviceMesh of {} dimensions names no single group; pass '
                             'mesh[axis] or mesh.get_group(axis)'.format(group.ndim))
        return group.get_group()
    if group is None:
        raise ValueError('a process group is required')
    return group
