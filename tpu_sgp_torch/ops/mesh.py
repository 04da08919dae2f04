"""Mesh axes bound to process groups: what a JAX axis name is inside
``shard_map``.

The JAX package names mesh axes in the solver's configuration
(``cfg.axis_names``, ``cfg.sync_axes``) and lets ``shard_map`` resolve them:
``psum`` / ``pmax`` reduce over the named axes and ``ppermute`` shifts along
one. The port runs SPMD, one process a rank, over a
``torch.distributed.device_mesh.DeviceMesh`` whose ``mesh_dim_names`` are
the JAX axis names. A distributed entry point binds the names of one solve
to the mesh's process groups with ``MeshAxes(mesh, names)``; the solver
passes that object where the JAX solver passes the names, and it lives as
long as the call.

One collective reduces a whole (B,) or (B, K) vector, never one a lane.

The gloo transport. NCCL takes CUDA tensors for everything here. Gloo, the
backend for CPU ranks and for several ranks sharing one card, takes CUDA
tensors in ``all_reduce`` and ``all_gather`` but not in point-to-point
sends (measured on the H100 host, ``PERF.md`` §3): on a gloo group the halo
strips of a CUDA tensor go through host memory, in ``exchange`` below. The
choice follows the group's backend, never an error.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..observability import host_flag

# collectives called, by kind, since the counts were last set to 0
CALLS = {'all_reduce': 0, 'exchange': 0, 'all_gather': 0}

_OPS = {'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX,
        'min': dist.ReduceOp.MIN}


class MeshAxes:
    """The named axes of a ``DeviceMesh`` as seen from this rank.

    ``group`` spans every rank that shares this rank's coordinates off the
    named axes; reductions run over it. ``shape`` and ``coord`` are the
    named axes' sizes and this rank's place on them, in the order of
    ``names``; ``ranks`` lists the group's global ranks row-major in that
    order, which is the order ``all_gather`` returns."""

    def __init__(self, mesh, names):
        names = tuple(names)
        dim_names = tuple(getattr(mesh, 'mesh_dim_names', None) or ())
        missing = [a for a in names if a not in dim_names]
        if not names or missing:
            raise ValueError(f'mesh axes {names} are not axes of the mesh '
                             f'{dim_names}')
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError('this rank is not part of the mesh')
        dims = [dim_names.index(a) for a in names]
        grid = mesh.mesh
        sub = grid[tuple(slice(None) if d in dims else coord[d]
                         for d in range(grid.dim()))]
        sub = sub.permute([sorted(dims).index(d) for d in dims])
        self.mesh = mesh
        self.names = names
        self.shape = tuple(sub.shape)
        self.size = math.prod(self.shape)
        self.coord = tuple(coord[d] for d in dims)
        self.ranks = [int(r) for r in sub.reshape(-1)]
        self._dims = dict(zip(names, dims))
        self._grid, self._coord = grid, list(coord)
        # one group over all the named axes, in the mesh's own axis order
        ordered = tuple(dim_names[d] for d in sorted(dims))
        self.group = (mesh.get_group(names[0]) if len(names) == 1
                      else mesh[ordered]._flatten().get_group())
        self.gloo = dist.get_backend(self.group) == 'gloo'

    def all_reduce(self, t: torch.Tensor, op: str = 'sum') -> torch.Tensor:
        """``psum`` / ``pmax`` / ``pmin`` over the axes: a new tensor."""
        out = t.contiguous().clone()
        dist.all_reduce(out, _OPS[op], group=self.group)
        CALLS['all_reduce'] += 1
        return out

    def any(self, flag: torch.Tensor) -> bool:
        """True on every rank if ``flag`` is True on any: the OR-reduced
        continue flag of a loop that must run the same trips everywhere."""
        return host_flag(self.all_reduce(flag.reshape(1).to(torch.int32),
                                         'max')[0])

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t``, stacked as (size, *t.shape) in the row-major
        order of the axes' coordinates."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        CALLS['all_gather'] += 1
        order = dist.get_process_group_ranks(self.group)
        return torch.stack([parts[order.index(r)] for r in self.ranks])

    def _neighbour(self, name: str, step: int):
        """Global rank one step along axis ``name``, None past the edge."""
        d = self._dims[name]
        at = self._coord[d] + step
        if not 0 <= at < self._grid.shape[d]:
            return None
        c = list(self._coord)
        c[d] = at
        return int(self._grid[tuple(c)])

    def exchange(self, name: str, to_prev: torch.Tensor,
                 to_next: torch.Tensor):
        """The non-wrapping ``ppermute`` pair along axis ``name``: send
        ``to_next`` one step up the axis and ``to_prev`` one step down, and
        return ``(from_prev, from_next)``, what the neighbours below and
        above sent; zeros at the axis' ends (and for an axis of size 1,
        with no communication). On a gloo group a CUDA strip travels
        through host memory (the module's gloo transport)."""
        prev, nxt = self._neighbour(name, -1), self._neighbour(name, +1)
        from_prev, from_next = torch.zeros_like(to_next), \
            torch.zeros_like(to_prev)
        if prev is None and nxt is None:
            return from_prev, from_next
        staged = self.gloo and to_next.is_cuda
        move = ((lambda a: a.cpu()) if staged
                else (lambda a: a.contiguous()))
        bufs, ops = {}, []
        group = self.mesh.get_group(name)
        if prev is not None:
            bufs['prev'] = move(from_prev)
            ops += [dist.P2POp(dist.isend, move(to_prev), prev, group),
                    dist.P2POp(dist.irecv, bufs['prev'], prev, group)]
        if nxt is not None:
            bufs['next'] = move(from_next)
            ops += [dist.P2POp(dist.isend, move(to_next), nxt, group),
                    dist.P2POp(dist.irecv, bufs['next'], nxt, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        CALLS['exchange'] += 1
        if 'prev' in bufs:
            from_prev = bufs['prev'].to(to_next.device)
        if 'next' in bufs:
            from_next = bufs['next'].to(to_prev.device)
        return from_prev, from_next


def resolve_axes(mesh, names):
    """``MeshAxes`` for ``names`` on ``mesh``, or ``()`` when no names are
    given (a single-device solve). Names without a mesh raise."""
    if not names:
        return ()
    if mesh is None:
        raise ValueError(f'mesh axes {tuple(names)} need the mesh they name: '
                         f'pass mesh= (a DeviceMesh with those '
                         f'mesh_dim_names)')
    return MeshAxes(mesh, names)
