"""The (ind, snp) mesh over the ranks.

The primary partition is SNP-sharding: the SNP-major genotype matrix Wt
(p, n) is split by rows over the ``snp`` axis and the n×n decision algebra
is replicated. An optional ``ind`` axis splits the individuals (Wt's
columns) for biobank-scale n. Each rank is one device (one process per
card), so a mesh of shape (ind, snp) needs ind·snp ranks; rank r sits at
(r // snp, r % snp), as the JAX package lays devices out in its mesh.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from eagleeverything_tpu_torch.utils import distributed

SNP_AXIS = "snp"
IND_AXIS = "ind"


class Mesh:
    """This rank's place in the mesh: ``shape`` {axis: size}, ``coord``
    {axis: index} and the process group of each axis (None in a
    single-process run without a group, where every collective is the
    identity)."""

    def __init__(self, shape: tuple[int, int], coord: tuple[int, int],
                 groups: Optional[dict] = None):
        self.shape = {IND_AXIS: shape[0], SNP_AXIS: shape[1]}
        self.coord = {IND_AXIS: coord[0], SNP_AXIS: coord[1]}
        self.groups = groups

    def group(self, axis: str):
        return None if self.groups is None else self.groups[axis]


def make_mesh(mesh_shape: Optional[tuple[int, int]] = None,
              device_type: str = "cpu") -> Mesh:
    """The (ind, snp) mesh over every rank. Default: 1 × world, every rank
    on the ``snp`` axis. With a group, the axes' groups come from
    ``torch.distributed.device_mesh.init_device_mesh`` over
    ``device_type``."""
    world = distributed.process_count()
    if mesh_shape is None:
        mesh_shape = (1, world)
    mesh_shape = (int(mesh_shape[0]), int(mesh_shape[1]))
    if mesh_shape[0] * mesh_shape[1] != world:
        raise ValueError(f"mesh_shape {mesh_shape} needs "
                         f"{mesh_shape[0] * mesh_shape[1]} processes, the "
                         f"run has {world}")
    if not dist.is_initialized():
        return Mesh(mesh_shape, (0, 0))
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device_type, mesh_shape,
                          mesh_dim_names=(IND_AXIS, SNP_AXIS))
    rank = distributed.process_index()
    return Mesh(mesh_shape, (rank // mesh_shape[1], rank % mesh_shape[1]),
                {IND_AXIS: dm.get_group(IND_AXIS),
                 SNP_AXIS: dm.get_group(SNP_AXIS)})


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
