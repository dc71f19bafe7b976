"""The (data, model) grid of processes and its shardings.

Counterpart of densematchingbenchmark_tpu/parallel/mesh.py:22-80. JAX lays
its devices out as a ('data', 'model') mesh and names how an array lies on
it; XLA inserts the collectives. Here each process is one cell of the
grid: rank r has data index ``r // n_model`` and model index
``r % n_model`` (JAX's row-major reshape), the ranks of one data index
form a model group, those of one model index a data group. A batch is
split over the data axis; a cost volume [B, D, ...] can also be split over
the model axis along D (``cost_volume_sharding``), each model rank holding
its planes of D as ``torch.tensor_split`` splits them, and the aggregators
move between that and the whole D (``batch_only_volume_sharding``) with
the D-axis collectives of parallel/collectives.py.

Outside a process group, or with one model rank, every sharding leaves D
whole and every D-axis collective is the identity.
"""

from typing import NamedTuple

import torch.distributed as dist

from . import collectives

DATA_AXIS = "data"
MODEL_AXIS = "model"

_grid = None        # the process group's grid, while its group is up


class Mesh:
    """One rank's view of the grid: its ``shape`` {'data': n_data,
    'model': n_model}, its ``data_index`` and ``model_index``, and its
    ``model_group`` (the ranks of its data index) and ``data_group`` (the
    ranks of its model index): ``torch.distributed`` groups, None where
    the grid has one model rank (then the data group is the world)."""

    def __init__(self, n_data, n_model, rank, model_group=None,
                 data_group=None):
        self.n_data, self.n_model = n_data, n_model
        self.data_index, self.model_index = divmod(rank, n_model)
        self.model_group, self.data_group = model_group, data_group

    @property
    def shape(self):
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    def __repr__(self):
        return (f"Mesh({self.shape}, data {self.data_index}, model "
                f"{self.model_index})")


def make_mesh(shape=None):
    """The (n_data, n_model) grid over the process group (by default
    (world size, 1)); one process without a group is the grid (1, 1).

    Every rank must call it, with the same shape: each model and data
    group is made by every rank, in the same order (``dist.new_group`` is
    collective over the world). The grid covers the whole group: JAX may
    leave devices out of a mesh, but a process outside the grid would have
    nothing to run here. The last grid made is the group's (``data_shards``)
    until ``shutdown_distributed``."""
    global _grid
    world, rank = collectives.world_size(), collectives.rank()
    n_data, n_model = (world, 1) if shape is None else tuple(shape)
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_model} over {world} "
                         f"process(es): the grid must cover the group")
    model_group = data_group = None
    if n_model > 1:
        for d in range(n_data):
            group = dist.new_group(list(range(d * n_model,
                                              (d + 1) * n_model)))
            if d == rank // n_model:
                model_group = group
        for m in range(n_model):
            group = dist.new_group(list(range(m, world, n_model)))
            if m == rank % n_model:
                data_group = group
    _grid = Mesh(n_data, n_model, rank, model_group, data_group)
    return _grid


def forget_mesh():
    """Drop the group's grid (its groups end with the process group)."""
    global _grid
    _grid = None


def data_shards():
    """(n_data, data index) of the group's grid, else (world size, rank):
    how a batch is split over the processes."""
    if _grid is not None and collectives.in_group():
        return _grid.n_data, _grid.data_index
    return collectives.world_size(), collectives.rank()


class Sharding(NamedTuple):
    """How an array lies on ``mesh``: ``spec`` names the mesh axis of each
    leading dimension (JAX's PartitionSpec), () replicated."""
    mesh: Mesh
    spec: tuple

    @property
    def splits_d(self):
        """Whether a [B, D, ...] volume so sharded holds only this rank's
        planes of D."""
        return self.spec[1:2] == (MODEL_AXIS,) and self.mesh.n_model > 1


def batch_sharding(mesh):
    """The leading batch dimension split over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated(mesh):
    return Sharding(mesh, ())


def cost_volume_sharding(mesh):
    """[B, D, H, W, ...]: batch on the data axis, D on the model axis."""
    return Sharding(mesh, (DATA_AXIS, MODEL_AXIS))


def batch_only_volume_sharding(mesh):
    """[B, D, H, W, ...]: batch on the data axis, D whole. JAX pins the
    strided stages of the aggregation trunks to it (its SPMD partitioner
    miscompiles window-strided convolutions over a sharded dimension); the
    aggregators here gather D before those stages and run them whole on
    every model rank."""
    return Sharding(mesh, (DATA_AXIS,))


def shard_batch(mesh, batch):
    """This rank's rows of a global batch (a dict of arrays or tensors
    with the batch first): the contiguous 1 / n_data of them at its data
    index, as the loader gives a process its slice."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % mesh.n_data:
            raise ValueError(f"{k}: batch {v.shape[0]} does not split "
                             f"over {mesh.n_data} data shards")
        per = v.shape[0] // mesh.n_data
        out[k] = v[mesh.data_index * per:(mesh.data_index + 1) * per]
    return out
