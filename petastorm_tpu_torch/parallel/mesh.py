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
  one-dimensional ``DeviceMesh``; :class:`Ring`: a rank's neighbours in
  such a group and the paired send/receive to them that ring attention and
  the pipeline's shift use.
- :class:`PartitionSpec`, a copy of JAX's: one mesh dimension name (or a
  tuple of names, or None) per tensor dimension. :func:`batch_sharding`
  turns one into the DTensor placements the loaders put on their batches:
  ``Shard(d)`` on the mesh dimension that names tensor dimension ``d``,
  ``Replicate()`` on every other.
- :func:`initialize_distributed`, the counterpart of the JAX package's gate
  over ``jax.distributed.initialize``: ``init_process_group`` with NCCL on
  the card (``gloo`` only for ``device='cpu'``), a no-op when a group is up.
- :func:`mesh_shard_info`: a reader's ``(cur_shard, shard_count)`` from one
  mesh dimension. On a ``('stage', 'data')`` mesh the reader is sharded by
  the data coordinate, not by the global rank
  (:func:`distributed_shard_info`): the stage ranks of one data coordinate
  read the same rows, as the JAX package replicates a batch over ``stage``.
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


class Ring(object):
    """This rank's place in ``group``: its index, the group's size and the
    global ranks of its neighbours."""

    def __init__(self, group):
        import torch.distributed as dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.index + 1) % self.size)
        self.prev = dist.get_global_rank(group, (self.index - 1) % self.size)

    def start(self, tensors, reverse=False):
        """Start sending ``tensors`` to the next rank and receiving their
        counterparts from the previous one (``reverse``: to the previous,
        from the next): ``(requests, received)``. Every rank posts the same
        sequence, so the transfers pair up on NCCL as on gloo (tags tell them
        apart there)."""
        import torch
        import torch.distributed as dist
        to, source = (self.prev, self.next) if reverse else (self.next, self.prev)
        received = [torch.empty_like(x) for x in tensors]
        ops = []
        for tag, (x, buf) in enumerate(zip(tensors, received)):
            ops.append(dist.P2POp(dist.isend, x.contiguous(), to, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, buf, source, self.group, tag))
        return (dist.batch_isend_irecv(ops) if ops else []), received


class PartitionSpec(tuple):
    """A tuple with one entry per tensor dimension: the name of the mesh
    dimension that shards it, a tuple of such names (sharded over their
    product, the first outermost), or None (not sharded). A copy of JAX's
    ``PartitionSpec``; a plain tuple of the same entries works too."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return 'PartitionSpec{}'.format(tuple.__repr__(self))


def spec_axes(entry):
    """The mesh dimension names of one spec entry, in order."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def batch_sharding(mesh, partition_spec=None, batch_axis='data'):
    """The DTensor placements, one per mesh dimension, of a tensor laid out
    by ``partition_spec`` on ``mesh`` (default: ``PartitionSpec(batch_axis)``,
    the batch dimension over ``batch_axis``): ``Shard(d)`` where the mesh
    dimension names tensor dimension ``d``, ``Replicate()`` elsewhere. An
    unknown or repeated mesh dimension raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard
    if partition_spec is None:
        partition_spec = PartitionSpec(batch_axis)
    names = tuple(mesh.mesh_dim_names or ())
    placements = [Replicate()] * len(names)
    seen = set()
    for dim, entry in enumerate(partition_spec):
        for axis in spec_axes(entry):
            if axis not in names:
                raise ValueError('partition spec {} names {!r}, which is not a dimension of '
                                 'the mesh {}'.format(partition_spec, axis, names))
            if axis in seen:
                raise ValueError('partition spec {} uses mesh dimension {!r} twice'
                                 .format(partition_spec, axis))
            seen.add(axis)
            placements[names.index(axis)] = Shard(dim)
    return tuple(placements)


def mesh_shard_info(mesh, axis='data'):
    """``(cur_shard, shard_count)`` for a reader fed to ``mesh``: this rank's
    coordinate along ``axis`` and the dimension's size."""
    return mesh.get_local_rank(axis), mesh[axis].size()


def initialize_distributed(init_method=None, world_size=None, rank=None, device=None):
    """``torch.distributed.init_process_group`` for this process, safe to call
    when a group is already up (then it does nothing). The backend is NCCL
    on the card and ``gloo`` only with ``device='cpu'``; CUDA without a card
    raises, as every entry point does. ``init_method`` None reads
    ``MASTER_ADDR``/``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (as
    ``torchrun`` sets them); a ``file://`` or ``tcp://localhost:<port>`` URL
    needs ``world_size`` and ``rank``. Returns whether it started a group,
    so that the caller destroys only a group it started."""
    import torch.distributed as dist

    from petastorm_tpu_torch.parallel.loader import resolve_device
    device = resolve_device(device)
    if dist.is_initialized():
        return False
    kwargs = {}
    if world_size is not None:
        kwargs['world_size'] = int(world_size)
    if rank is not None:
        kwargs['rank'] = int(rank)
    dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo',
                            init_method=init_method, **kwargs)
    return True
