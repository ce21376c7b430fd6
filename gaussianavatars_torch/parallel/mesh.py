"""The ('data', 'prim') process mesh (port of
`gaussianavatars_tpu/parallel/mesh.py`).

Axes, as in the JAX package:
  data  camera / subject parallelism: each data group takes its own camera
        (or trains its own subject)
  prim  the render-parallel axis: Gaussians sharded for the projection and
        the optimizer, tile rows sharded for the blend

The JAX mesh is a grid of devices driven by one program; here it is a grid
of `torch.distributed` processes (SPMD), one device each. Rank r sits at
(data, prim) = divmod(r, n_prim), the rank-major layout of the JAX
package's `reshape(n_data, n_prim)` of its device list. Each rank holds two
process groups: `prim_group`, the n_prim ranks of its data group, and
`data_group`, the n_data ranks that share its prim index.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class Mesh:
    """One rank's view of the (n_data, n_prim) mesh.

    `shape` maps "data" and "prim" to the axis sizes (read as
    `mesh.shape["prim"]`, as in JAX). `data_index` / `prim_index` are this
    rank's coordinates. `prim_group` / `data_group` are None on the local
    mesh, a (1, 1) mesh of one process without `torch.distributed`, where
    every collective of `parallel/sharded.py` is the identity.
    """

    def __init__(self, n_data: int, n_prim: int, data_index: int = 0,
                 prim_index: int = 0, prim_group=None, data_group=None):
        self.shape = {"data": n_data, "prim": n_prim}
        self.data_index = data_index
        self.prim_index = prim_index
        self.prim_group = prim_group
        self.data_group = data_group

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["prim"]

    @property
    def local(self) -> bool:
        return self.prim_group is None

    def group(self, axis: str):
        return self.prim_group if axis == "prim" else self.data_group

    def shard_rows(self, n: int) -> int:
        """Rows of every prim shard of n rows but the last, which holds the
        rest (possibly none): ceil(n / n_prim)."""
        return -(-n // self.shape["prim"])

    def shard(self, n: int) -> slice:
        """This rank's contiguous rows of an n-row axis sharded over prim."""
        rows = self.shard_rows(n)
        start = min(self.prim_index * rows, n)
        return slice(start, min(start + rows, n))


def make_mesh(n_data: int = 1, n_prim: Optional[int] = None) -> Mesh:
    """The ('data', 'prim') mesh over the ranks of the default process
    group (`torch.distributed` initialized, e.g. by
    `parallel/distributed.py::initialize_distributed`). Without
    `torch.distributed` only the local (1, 1) mesh exists.

    `n_prim` defaults to world_size // n_data. Every rank must call this
    (the subgroups are made collectively); ranks at or beyond n_data *
    n_prim get coordinates None and no groups.
    """
    if not dist.is_initialized():
        if n_data != 1 or n_prim not in (None, 1):
            raise RuntimeError(
                f"a ({n_data}, {n_prim}) mesh needs torch.distributed; "
                "initialize it first (parallel/distributed.py)")
        return Mesh(1, 1)
    world = dist.get_world_size()
    if n_prim is None:
        if world % n_data:
            raise ValueError(f"world size {world} is not a multiple of "
                             f"n_data {n_data}")
        n_prim = world // n_data
    if n_data * n_prim > world:
        raise ValueError(f"a ({n_data}, {n_prim}) mesh needs "
                         f"{n_data * n_prim} ranks; the world has {world}")
    rank = dist.get_rank()
    # every rank creates every group, in one order (new_group is collective)
    prim_groups = [dist.new_group([d * n_prim + p for p in range(n_prim)])
                   for d in range(n_data)]
    data_groups = [dist.new_group([d * n_prim + p for d in range(n_data)])
                   for p in range(n_prim)]
    if rank >= n_data * n_prim:
        mesh = Mesh(n_data, n_prim)
        mesh.data_index = mesh.prim_index = None
        return mesh
    d, p = divmod(rank, n_prim)
    return Mesh(n_data, n_prim, d, p, prim_groups[d], data_groups[p])


def mesh_device(device: str | torch.device) -> torch.device:
    """`device` with the index of this rank's card: torch.distributed ranks
    pin their card with `torch.cuda.set_device`, and a bare "cuda" names
    the current one."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
