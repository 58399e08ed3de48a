"""The scan's collectives over the (ind, snp) mesh: the psum-merged MMt, the
sharded score sweep with its collective argmax, and the winning column's
gather (the JAX package's parallel/collectives.py, as ``torch.distributed``
calls on each rank's own tensors).

An iteration of the SNP-sharded sweep communicates once for its partials
over ``ind`` (no-op at ind = 1), then for the argmax (a MAX and a MIN
all-reduce over ``snp``) and the statistic vector (an all-gather over
``snp``); MMt communicates once a run. On an (ind > 1, snp) mesh each rank
holds a column slice of its row block: every contraction over individuals
is a partial, summed over ``ind`` before scoring.

Every rank of an axis group receives the same bits from a collective, so
every decision that reads one is taken alike everywhere. Without a group
(one process) each collective is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from eagleeverything_tpu_torch.ops import kernels
from eagleeverything_tpu_torch.parallel.mesh import IND_AXIS, SNP_AXIS, Mesh

_INT_MAX = torch.iinfo(torch.int64).max


def _all_reduce(t: torch.Tensor, mesh: Mesh, axis: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    group = mesh.group(axis)
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(t: torch.Tensor, mesh: Mesh, axis: str,
                dim: int = 0) -> torch.Tensor:
    """Concatenate the axis group's tensors along ``dim`` in mesh order."""
    group = mesh.group(axis)
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _argmax_over_snp(t: torch.Tensor, mesh: Mesh):
    """Deterministic collective argmax of the shard-local statistics t
    (p_loc,): the lowest global SNP index wins ties (within a shard by
    argmax's first match, across shards by a MIN over the candidates at
    the MAX). Returns (t gathered over ``snp``, global index, global max),
    0-d tensors for the last two; a global max of 0 means nothing is left
    to score (index 0 is then no selection)."""
    p_loc = t.shape[0]
    i_loc = torch.argmax(t)
    m_loc = t[i_loc]
    g_idx = i_loc + mesh.coord[SNP_AXIS] * p_loc
    m_glob = _all_reduce(m_loc.reshape(1).clone(), mesh, SNP_AXIS,
                         dist.ReduceOp.MAX)
    cand = torch.where(m_loc >= m_glob, g_idx.reshape(1),
                       torch.full_like(g_idx.reshape(1), _INT_MAX))
    i_glob = _all_reduce(cand, mesh, SNP_AXIS, dist.ReduceOp.MIN)
    return _all_gather(t, mesh, SNP_AXIS), i_glob[0], m_glob[0]


def mmt_psum(Wt: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """K = Wtᵀ·Wt (n, n) f32 from the rank's block of the SNP-sharded Wt:
    the columns are gathered over ``ind`` once (MMt needs the cross-blocks
    between column slices), the shard's product is summed over ``snp``."""
    W = _all_gather(Wt.to(torch.float32), mesh, IND_AXIS, dim=1)
    return _all_reduce(W.T @ W, mesh, SNP_AXIS)


def score_and_argmax(Wt: torch.Tensor, Lp: torch.Tensor, Py: torch.Tensor,
                     sigma2_g, tmask: torch.Tensor, mesh: Mesh):
    """The sharded Lp-form sweep and its collective argmax.

    Wt: the rank's (p_loc, n_loc) block; Lp (n_loc, m) and Py (n_loc,)
    the rank's rows of the projector factor (P̃ = Lp·Lpᵀ) and of P̃y;
    tmask (p_loc,) f32 {0, 1}, 0 for selected and padded SNPs. Returns
    (t (p_pad,), global index, global max) as :func:`_argmax_over_snp`."""
    W = Wt.to(torch.float32)
    parts = torch.cat([(W @ Py)[:, None], W @ Lp], dim=1)
    parts = _all_reduce(parts, mesh, IND_AXIS)
    ahat, b = parts[:, 0], parts[:, 1:]
    vara = sigma2_g * torch.sum(b * b, dim=1)
    return _argmax_over_snp(kernels.t_from_ahat_vara(ahat, vara) * tmask,
                            mesh)


def score_and_argmax_from_T(T: torch.Tensor, s: torch.Tensor,
                            Q: torch.Tensor, z3: torch.Tensor, sigma2_g,
                            tmask: torch.Tensor, mesh: Mesh):
    """The collective sweep over the rank's block of the eigenbasis tiles
    T = Wt·U (p_loc, n_loc) with its slices of s, Q (n_loc, q) and z3: â,
    ‖Ts‖²_row and Ts·Q are partials summed over ``ind``, then scored with
    kernels.score_from_T_parts (the tiled path's guard)."""
    Ts = T * s[None, :]
    parts = torch.cat([(T @ z3)[:, None], torch.sum(Ts * Ts, dim=1)[:, None],
                       Ts @ Q], dim=1)
    parts = _all_reduce(parts, mesh, IND_AXIS)
    t = kernels.score_from_T_parts(parts[:, 0], parts[:, 1], parts[:, 2:],
                                   sigma2_g)
    return _argmax_over_snp(t * tmask, mesh)


def gather_column(Wt: torch.Tensor, j: int, mesh: Mesh) -> torch.Tensor:
    """Global row j of the SNP-sharded Wt, (n,) on every rank: its owning
    shard sends the row, the others zeros (a SUM over ``snp``), then the
    columns are gathered over ``ind``."""
    p_loc = Wt.shape[0]
    owner = j // p_loc
    row = (Wt[j - owner * p_loc].clone() if mesh.coord[SNP_AXIS] == owner
           else torch.zeros_like(Wt[0]))
    row = _all_reduce(row, mesh, SNP_AXIS)
    return _all_gather(row, mesh, IND_AXIS)
