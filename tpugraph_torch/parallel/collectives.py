"""Differentiable collectives over a process group (no module of
``tpugraph`` holds these: JAX transposes ``psum``, ``all_gather`` and
``all_to_all`` itself inside ``shard_map``).

* :func:`psum` — ``jax.lax.psum`` as ``shard_map(check_vma=False)``
  differentiates it: a sum over the ranks whose gradient is again the sum
  of the ranks' gradients;
* :func:`reduce_from_shards` / :func:`copy_to_shards` — the pair that
  keeps a replicated value's gradient replicated around a computation
  split over the ranks (a sum of per-rank partials; a value every rank
  holds whole): ``reduce`` sums forward and passes the gradient through,
  ``copy`` passes forward and sums the gradient;
* :func:`all_gather_rows` — every rank's rows in rank order; the gradient
  of a rank's rows is the sum of every rank's gradient of them;
* :func:`all_gather_cols` — every rank's column block in rank order, the
  join of a column-sharded (tensor-parallel) product; what follows it
  runs replicated, so every rank holds the same gradient of the joined
  tensor and its backward keeps this rank's columns of it (a sum would
  give ``n`` times the gradient);
* :func:`all_to_all` — block ``q`` of the input to rank ``q``, block ``q``
  of the output from rank ``q`` (equal blocks along the first axis); its
  gradient is the reverse exchange, which is the same operation;
  :func:`start_all_to_all` issues it asynchronously and returns a handle
  whose ``wait`` gives the result.

* :func:`gather_to_first` — every rank's rows, in rank order, on the
  group's first rank (outside autograd): results collected for output.

The collectives are ``torch.distributed``'s (gloo on the CPU, NCCL on the
cards); ``group`` ``None`` is the default group.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


class _AllGatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.cols = x.shape[-1]
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g[..., r * ctx.cols:(r + 1) * ctx.cols].contiguous(), None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over equal first-axis blocks; ``pending`` (a
    list) asks for an asynchronous launch and receives its work handle."""

    @staticmethod
    def forward(ctx, x, group, pending):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=group,
                                      async_op=pending is not None)
        if pending is not None:
            pending.append(work)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None, None


def psum(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    return _PSum.apply(x, group)


def reduce_from_shards(x: torch.Tensor,
                       group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    return _Reduce.apply(x, group)


def copy_to_shards(x: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    return _Copy.apply(x, group)


def all_gather_rows(x: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    return _AllGatherRows.apply(x, group)


def all_gather_cols(x: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    return _AllGatherCols.apply(x, group)


def all_to_all(x: torch.Tensor,
               group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    return _AllToAll.apply(x, group, None)


class PendingExchange:
    """An :func:`all_to_all` in flight: :meth:`wait` returns its result."""

    def __init__(self, out: torch.Tensor, works: List, finish=None):
        self._out, self._works, self._finish = out, works, finish

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        self._works = []
        return self._finish(self._out) if self._finish else self._out


def start_all_to_all(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
                     finish=None) -> PendingExchange:
    """Issue :func:`all_to_all` without waiting; ``finish`` (optional)
    maps the result when :meth:`PendingExchange.wait` returns it."""
    works: List = []
    return PendingExchange(_AllToAll.apply(x, group, works), works, finish)


def all_reduce_(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """In-place sum over the ranks, outside autograd; returns ``x``."""
    dist.all_reduce(x, group=group)
    return x


def gather_to_first(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                    ) -> Optional[torch.Tensor]:
    """Every rank's ``x`` (one shape on every rank) joined along the first
    axis in rank order on the group's first rank, ``None`` on the others;
    outside autograd."""
    first = 0 if group is None else dist.get_global_rank(group, 0)
    x = x.detach().contiguous()
    mine = dist.get_rank() == first
    parts = ([torch.empty_like(x) for _ in range(dist.get_world_size(group))]
             if mine else None)
    dist.gather(x, parts, dst=first, group=group)
    return torch.cat(parts) if mine else None
