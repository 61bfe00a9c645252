"""Device meshes over the process group, and the batch/param placement helpers.

Twin of focnerf_tpu/parallel/mesh.py. JAX places arrays on a mesh of
devices owned by one process; here every rank is one device of a
``torch.distributed.device_mesh.DeviceMesh`` and holds its own tensors:

  - ``make_mesh`` spans every rank: 1-D over ``("data",)``, or 2-D over
    ``("data", "slice")`` for the hybrid voxel step (rank = data * slices +
    slice). The mesh's dimensions give the process groups the steps reduce
    over (``mesh.get_group(name)``);
  - ``shard_batch`` keeps this rank's contiguous block of rows of every
    entry whose leading axis divides over the mesh axis, and keeps the
    others whole (JAX's replication rule);
  - ``replicate`` broadcasts every tensor of a tree from rank 0.

With one process per device, JAX's multi-process variants
(``shard_batch_global``, ``replicate_global``: every process passes the same
global value) are the same functions.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.distributed as dist


def tree_map(fn, tree):
    """``fn`` over every tensor of a dict / list / tuple / NamedTuple tree;
    other leaves are kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def make_mesh(
    shape: Union[None, int, Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data",),
    device=None,
):
    """A DeviceMesh over every rank of the default group (``initialize``s a
    world-1 group first if there is none). ``shape`` None spans the world
    on one axis; a tuple gives one size per axis name, and its product must
    be the world size (each rank is one device)."""
    from torch.distributed.device_mesh import init_device_mesh

    from focnerf_tpu_torch import resolve_device
    from focnerf_tpu_torch.parallel.distributed import initialize

    device = resolve_device(device)
    initialize(device=device)
    world = dist.get_world_size()
    shape = (world,) if shape is None else ((shape,) if isinstance(shape, int) else tuple(shape))
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match the axis names {tuple(axis_names)}")
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a mesh of shape {shape} needs {n} ranks; the world has {world}")
    return init_device_mesh(device.type, shape, mesh_dim_names=tuple(axis_names))


def _axis_coordinate(mesh, axis: str) -> Tuple[int, int]:
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def shard_batch(batch, mesh, axis: str = "data"):
    """This rank's rows of a batch tree: entries whose leading axis divides
    over ``axis`` keep their contiguous block (block i on coordinate i);
    scalars and entries that do not divide (e.g. obj_feat [F]) stay whole."""
    i, n = _axis_coordinate(mesh, axis)

    def rows(x):
        if x.dim() >= 1 and x.shape[0] >= n and x.shape[0] % n == 0:
            per = x.shape[0] // n
            return x[i * per:(i + 1) * per]
        return x

    return tree_map(rows, batch)


def replicate(tree, mesh=None):
    """Every tensor of ``tree`` as rank 0 holds it, on every rank (copies)."""
    del mesh  # every mesh spans the default group

    def bcast(x):
        x = x.detach().contiguous().clone()
        dist.broadcast(x, src=0)
        return x

    return tree_map(bcast, tree)


shard_batch_global = shard_batch
replicate_global = replicate

