"""The collectives of the parallel layouts, written out by hand.

The JAX package runs each layout as one GSPMD program and XLA inserts its
collectives. Here every rank is a process of its own, and these functions
are the collectives, each an autograd Function where a gradient passes
through it:

- `copy_to_model`: identity forward, all-reduce (SUM) of the gradient over
  the model group backward. It goes where a replicated tensor enters a
  computation that the model group holds in parts (the encoder FFN's input
  under tp, the experts' input, the gates and the towers' weights under ep).
- `reduce_from_model`: all-reduce (SUM) over the model group forward,
  identity backward. It sums the parts (the FFN's partial products, the
  towers' partial mixes over the experts).
  The two are Megatron-LM's f and g.
- `gather_rows`: all-gather of the data ranks' output rows forward, cut
  back to the batch's rows in plan order with the padding dropped; backward
  this rank's rows of the gradient. Every data rank then evaluates the
  criterion on the whole batch.
- `all_reduce_grads`: one all-reduce (SUM) over the data group of all the
  parameters' gradients as one flat buffer.

Each counts its collectives in `CALLS` by "<group>:<op>" where it issues
them; a CUDA graph's replay adds the ones its capture issued
(`utils/graphs.py`), as it does the kernels' launches.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

CALLS: collections.Counter = collections.Counter()


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    CALLS[f"{group.name}:all_reduce"] += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.handle)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) from each of the group's `size` ranks -> (size * n, ...),
    rank by rank."""
    CALLS[f"{group.name}:all_gather"] += 1
    t = t.contiguous()
    out = torch.empty((group.size * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    if group.backend == "nccl":
        dist.all_gather_into_tensor(out, t, group=group.handle)
    else:
        dist.all_gather(list(out.chunk(group.size)), t, group=group.handle)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, batch):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather(x, group)[:batch]

    @staticmethod
    def backward(ctx, g):
        start = ctx.group.rank * ctx.rows
        part = g[start:start + ctx.rows]
        if part.shape[0] < ctx.rows:  # padding rows past the batch: no gradient
            part = torch.cat([part, g.new_zeros((ctx.rows - part.shape[0], *g.shape[1:]))])
        return part, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def gather_rows(x: torch.Tensor, group, batch: int) -> torch.Tensor:
    """The data group's rows of x, (size * rows, ...) in rank order, cut to
    the batch's first `batch` rows."""
    return _GatherRows.apply(x, group, batch)


def gather_outputs(output, group, batch: int):
    """`gather_rows` of a model's output: one tensor or a list of heads."""
    if isinstance(output, (list, tuple)):
        return [gather_rows(h, group, batch) for h in output]
    return gather_rows(output, group, batch)


@torch.no_grad()
def all_reduce_grads(params, group) -> None:
    """Sum every parameter's gradient over `group` as one flat buffer, in
    place (a parameter without one takes zeros: it had none on this rank)."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    _all_reduce(flat, group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))
