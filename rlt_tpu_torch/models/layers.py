"""Shared layers of the port, with torch-matching semantics and layouts.

The counterpart of the JAX package's `models/layers.py` for what MMOECut
and PLECut serving and training run: `TorchLinear`, the stacked
bidirectional `LSTM` over the ranked list, multi-head `SelfAttention`
(head-packed or per-slice attention by head width), the post-LayerNorm
`TransformerEncoderLayer` (eps 1e-5, ReLU FFN of width 2048),
`TransformerEncoder`, the towers with the logit-space expert mix, and the
dropout of the training forward.

Parameter names and layouts match the JAX package's (and so torch's):
LSTM `weight_ih_l{n}[_reverse]` (4H, F) in gate order i, f, g, o; Linear
weight (out, in); attention `in_proj_weight` rows [q; k; v], each block
head-major. The JAX package runs its experts under `nn.vmap`, which gives
every expert parameter a leading axis E. Here the encoder layers keep that
axis (`experts=E`) and run the E experts as one batched computation on
(E, B, L, D) activations; a (B, L, D) input is shared by every expert. With
`experts=None` (the default) a layer is one plain encoder, as AttnCut's and
MtAttnCut's: its parameters have no E axis, as the JAX leaves, and it maps
(B, L, D) to (B, L, D).

Population training (`rlt_tpu_torch/population.py`; the JAX package runs
its `jax.vmap` over members) carries a further leading MEMBER axis K on
every parameter, written out as the expert axis is (`members=K`): the
BiLSTM maps (K, B, L, F) to (K, B, L, 2H) through one member-batched LSTM
op per layer (ndir = 2K), the expert layers take (K, 1, B, L, D) or (K, E,
B, L, D) with (K, E, ...) parameters and run their attention over the
K * E * B rows (or PLECut's K * E * B * H slices) at once, an unstacked
encoder's layers map (K, B, L, D) to (K, B, L, D) over K * B rows, and the
towers, gates and heads carry K in front. Each member computes what its
own model computes, and in float32 on the card bit for bit whatever
members share the model: where a member's parameter is broadcast over its
rows (a bias, a LayerNorm's affine map, a tower shared by the experts,
Choopy's position encoding) its gradient is summed one member at a time
(`member_broadcast`), and so is the weight gradient of a product into one
column, a tower's or a head's (`_MemberProduct`): torch's reduction kernels
split a sum by the count of its outputs, and cuBLAS picks such a thin
product's split by the batch count, so these sums over K members' rows
rounded differently at another K. This holds a member's f32 bits at K =
2 and 4 for every model on the card, and at K = 8 for the models without
an expert stack; the expert models' bits at K = 8 still depend on K, and
in bf16 (whose sums stay batched) every model's do. The members may
differ in their dropout rate (the JAX
package's traced `hp["dropout_rate"]`): a layer then holds a
`MemberRates` in place of its float rate, and every dropout site takes
member m's rate, 16-bit mask threshold and 1 / keep scale from it.

In training mode (`module.train()`) with a dropout rate above 0, every
random bit comes from the explicit `torch.Generator` the caller passes to
`forward`, on the activations' device: the attention's per-expert dropout
seeds first, then the three masks of each encoder layer, in the order of
the JAX package's `TransformerEncoderLayer`. A model with members takes a
list of K generators, one per member: each site draws member m's seeds or
mask, of the shape its own model draws, from generator m, so that member m
draws exactly the bits of its own run with that generator (a member at
rate 0 draws nothing, as its own model draws nothing). `Dropout` and
`ReluDropout` use the JAX package's 16-bit scheme (16 random bits per unit against
min(round(keep * 65536), 65535)); the bits are torch's, not JAX's, so a
whole-model comparison with the JAX package is made at rate 0. In eval mode
the forward draws nothing and runs exactly the serving computation.
Initial values follow the torch distributions the JAX package reproduces,
drawn from an explicit `torch.Generator`.

In bf16 (a module cast with `.to(torch.bfloat16)`, as `infer.Predictor`
serves it) every layer rounds where the JAX package's does on bf16
parameters and inputs: each product and each bias add rounds to bf16 (the
products accumulate in f32), the LSTM and attention kernels run their bf16
instances, `LayerNorm` takes its statistics and its affine map in f32 and
rounds once (flax's `LayerNorm`), and `softmax` and `sigmoid` follow the
ops of `jax.nn.softmax` and `jax.nn.sigmoid` on bf16. Where the JAX code
widens a bf16 result to f32 right after the op that makes it, XLA keeps
that op's f32 result unrounded (its default excess precision), and so does
the port: the residual sums that enter a LayerNorm, the exps that a
softmax sums, and the last op of every output head, whose f32 result is
what the JAX package's Predictor decodes (`final=True` below).

Training in bf16 (`compute_params` below, as the JAX package's
`build_epoch_fn` casts its f32 parameters inside the loss) differentiates
that forward. Most ops are differentiated by autograd through their f32 and
bf16 steps. `softmax` and `sigmoid` have backwards of their own, the ones
XLA derives for `jax.nn.softmax` and `jax.nn.sigmoid` on bf16 with every op
rounding to bf16. The LSTM's recurrent weights reach its op in f32 (see
`compute_params`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from rlt_tpu_torch.ops.attention import (
    RowDropout,
    expert_streams,
    fused_attention,
    fused_attention_packed,
    packed_group_size,
    row_dropout,
)
from rlt_tpu_torch.ops.lstm import fused_lstm, fused_lstm_bidir
from rlt_tpu_torch.parallel.functional import copy_to_model, reduce_from_model


def _uniform(shape, bound: float, generator: torch.Generator | None) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(t)


def _lead(experts: int | None, members: int | None = None) -> tuple:
    """The leading parameter axes: (K,) for `members`, then (E,) for
    `experts`."""
    return (() if members is None else (members,)) + (() if experts is None else (experts,))


# ---------------------------------------------------------------------------
# Dropout (the JAX package's 16-bit scheme)
# ---------------------------------------------------------------------------

def _generator(generator: torch.Generator | None) -> torch.Generator:
    if generator is None:
        raise ValueError("the training forward with dropout draws its masks "
                         "from an explicit torch.Generator: pass generator=")
    return generator


def member_draw(generator, draw) -> torch.Tensor:
    """draw(g) from the generator, or with a list of K member generators,
    draw(g_m) from each member's own, stacked on a leading member axis."""
    if isinstance(generator, (list, tuple)):
        return torch.stack([draw(_generator(g)) for g in generator])
    return draw(_generator(generator))


def _mask_threshold(keep: float) -> int:
    return min(round(keep * 65536.0), 65535)


class MemberRates(nn.Module):
    """The dropout rates of K members that differ in them, as a member
    model's layers hold them in place of one float rate: the rates, and the
    attention kernels' `RowDropout` of the K members (device buffers, made
    once on the host and moved with the model, so that a CUDA graph of the
    step reads fixed addresses; not in the state_dict)."""

    def __init__(self, rates: Sequence[float]):
        super().__init__()
        self.rates = tuple(float(r) for r in rates)
        for name, t in zip(RowDropout._fields, row_dropout(self.rates)):
            self.register_buffer(f"row_{name}", t, persistent=False)

    def rows(self, n: int) -> RowDropout:
        """The kernels' per-row dropout of K * n rows, n a member in turn."""
        return RowDropout(self.row_rate, self.row_threshold, self.row_scale).repeat(n)

    def scaled(self, x: torch.Tensor) -> torch.Tensor:
        """x (K, ...) with member m's part over its keep = 1 - rate: the op
        of member m's own model, x / keep with a Python float keep, one per
        member into one output (torch rounds that op by device and dtype;
        the same op rounds the same)."""
        y = torch.empty_like(x)
        for m, rate in enumerate(self.rates):
            torch.div(x[m], 1.0 - rate, out=y[m])
        return y


class _MemberScale(torch.autograd.Function):
    """`MemberRates.scaled`, differentiated as torch differentiates x / keep
    for a Python float keep: the cotangent over the same keep."""

    @staticmethod
    def forward(ctx, x, rates):
        ctx.rates = rates
        return rates.scaled(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.rates.scaled(g), None


Rate = Union[float, MemberRates]


def member_rates(rate: float | Sequence[float]) -> Rate:
    """A layer's rate: a float, or K members' rates, which stay one float
    where they agree."""
    if isinstance(rate, (int, float)):
        return float(rate)
    rates = tuple(float(r) for r in rate)
    return rates[0] if len(set(rates)) == 1 else MemberRates(rates)


def drops(rate: Rate) -> bool:
    """Whether any unit is dropped at `rate` (a MemberRates always has a
    member above 0)."""
    return isinstance(rate, MemberRates) or rate > 0.0


def dropout_keep_mask(shape, keep: float | Sequence[float], generator,
                      device: torch.device) -> torch.Tensor:
    """16 random bits per unit against min(round(keep * 65536), 65535).
    With a list of K member generators `shape` leads with the member axis,
    and member m's (shape[1:]) bits come from generator m; with K keeps,
    member m's bits against its own threshold, and a member at keep 1 (rate
    0) draws nothing and keeps every unit."""
    shape = tuple(shape)
    if isinstance(generator, (list, tuple)):
        if shape[0] != len(generator):
            raise ValueError(f"{len(generator)} member generators for a mask of "
                             f"shape {shape}")
        shape = shape[1:]
    if isinstance(keep, (int, float)):
        threshold = _mask_threshold(keep)
        return member_draw(generator, lambda g: torch.randint(
            0, 65536, shape, generator=g, device=device, dtype=torch.int32) < threshold)
    masks = [torch.randint(0, 65536, shape, generator=_generator(g), device=device,
                           dtype=torch.int32) < _mask_threshold(k) if k < 1.0
             else torch.ones(shape, dtype=torch.bool, device=device)
             for g, k in zip(generator, keep)]
    return torch.stack(masks)


@dataclasses.dataclass(frozen=True)
class Part:
    """A layer's part under a parallel layout (`rlt_tpu_torch/parallel/
    sharding.py::shard_module` sets it): where this rank's share of the
    layer's activations lies in the whole, as (whole size, start) on an
    axis. `rows` on the batch axis (-3) of every activation: the data
    rank's rows of the plan's B (rows past B are the padding); `experts` on
    the expert axis (-4) under ep; `columns` on the FFN's hidden axis (-1)
    under tp; `group` the model group of ep's and tp's collectives. Each
    dropout mask and the attention's seeds are drawn whole, as the one
    process draws them, and the rank takes its share: every layout draws
    the bits of the one process."""

    rows: tuple[int, int] | None = None
    experts: tuple[int, int] | None = None
    columns: tuple[int, int] | None = None
    group: Any = None


def _part_mask(shape, draw, part: Part | None, columns: bool) -> torch.Tensor:
    """draw(whole shape) cut to this rank's share of `shape`; rows past the
    whole batch (the padding) are kept."""
    axes = []
    if part is not None:
        if part.rows is not None:
            axes.append((-3, *part.rows))
        if part.experts is not None and len(shape) >= 4:
            axes.append((-4, *part.experts))
        if columns and part.columns is not None:
            axes.append((-1, *part.columns))
    whole = list(shape)
    for axis, size, _ in axes:
        whole[axis] = size
    mask = draw(tuple(whole))
    for axis, size, start in axes:
        n = shape[axis]
        if start + n > size:
            pad = list(mask.shape)
            pad[axis] = start + n - size
            mask = torch.cat([mask, mask.new_ones(pad)], dim=axis)
        mask = mask.narrow(axis, start, n)
    return mask


def _keep_mask(x: torch.Tensor, rate: Rate, generator, part: Part | None = None,
               columns: bool = False) -> torch.Tensor:
    keep = ([1.0 - r for r in rate.rates] if isinstance(rate, MemberRates)
            else 1.0 - rate)
    return _part_mask(x.shape, lambda shape: dropout_keep_mask(
        shape, keep, generator, x.device), part, columns)


def _keep_of(rate: Rate) -> float | MemberRates:
    return rate if isinstance(rate, MemberRates) else 1.0 - rate


def _over_keep(x: torch.Tensor, keep: float | MemberRates) -> torch.Tensor:
    """x / keep, each member's own with a MemberRates."""
    if isinstance(keep, MemberRates):
        return _MemberScale.apply(x, keep)
    return x / keep


def dropout(x: torch.Tensor, rate: Rate, generator, part: Part | None = None) -> torch.Tensor:
    """Drop units with probability `rate`, scale the kept ones by 1 / keep
    (member m's rate with a MemberRates and x leading with the members); x
    this rank's `part` of the whole activation."""
    mask = _keep_mask(x, rate, generator, part)
    return torch.where(mask, _over_keep(x, _keep_of(rate)), 0.0)


class ReluDropout(torch.autograd.Function):
    """relu(x) * mask / keep whose only saved tensor is the output h:
    dx = g (h > 0) / keep, which equals autograd's g mask (x > 0) / keep
    because kept positives give h > 0 and dropped or negative units h = 0
    (the JAX package's `_relu_dropout` custom_vjp). `keep`: a float, or a
    MemberRates for each member's own."""

    @staticmethod
    def forward(ctx, x, mask, keep):
        h = torch.where(mask, _over_keep(torch.relu(x), keep), 0.0)
        ctx.save_for_backward(h)
        ctx.keep = keep
        return h

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        return torch.where(h > 0, _over_keep(g, ctx.keep), 0.0), None, None


def relu_dropout(x: torch.Tensor, rate: Rate, generator,
                 part: Part | None = None) -> torch.Tensor:
    """`ReluDropout` of the FFN's hidden units x, this rank's `part` of
    them (its columns under tp)."""
    mask = _keep_mask(x, rate, generator, part, columns=True)
    return ReluDropout.apply(x, mask, _keep_of(rate))


class _MemberBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, shape):
        ctx.shape = t.shape
        ctx.dims = [i - 1 for i in range(1, len(shape)) if t.shape[i] == 1 and shape[i] != 1]
        return t.expand(shape)

    @staticmethod
    def backward(ctx, g):
        if not ctx.dims:
            return g, None
        out = g.new_empty(ctx.shape)
        for m in range(g.shape[0]):
            torch.sum(g[m], dim=ctx.dims, keepdim=True, out=out[m])
        return out, None


class _MemberProduct(torch.autograd.Function):
    """x @ wt of members' stacked rows into one column (a tower's or a
    head's logit), x (K, E, N, in) and wt (K, E, in, 1) (or K for E), whose
    weight gradient is one product a member, written into its slab."""

    @staticmethod
    def forward(ctx, x, wt):
        ctx.save_for_backward(x, wt)
        return torch.matmul(x, wt)

    @staticmethod
    def backward(ctx, g):
        x, wt = ctx.saved_tensors
        gw = g.new_empty(wt.shape)
        for m in range(g.shape[0]):
            torch.matmul(x[m].transpose(-1, -2), g[m], out=gw[m])
        return torch.matmul(g, wt.transpose(-1, -2)).sum_to_size(x.shape), gw


def member_broadcast(t: torch.Tensor, shape) -> torch.Tensor:
    """t (K, ...) broadcast to `shape` (K, ...), as `expand`, with its
    gradient summed to t's shape one member at a time in float32: the same
    sum of the same shape at any K (module docstring). Other dtypes
    broadcast as `expand` does."""
    if t.dtype != torch.float32:
        return t.expand(shape)
    return _MemberBroadcast.apply(t, tuple(shape))


def _add_broadcast(y: torch.Tensor, b: torch.Tensor, members: bool) -> torch.Tensor:
    """y + b, b broadcast to y's shape (`member_broadcast` with members)."""
    return y + (member_broadcast(b, y.shape) if members else b)


def final_linear(linear: "TorchLinear", x: torch.Tensor) -> torch.Tensor:
    """`linear(x)` as an output head: on bf16 the product rounds and the
    bias add stays f32 (the JAX package's Predictor widens it at once)."""
    if x.dtype != torch.bfloat16:
        return linear(x)
    w, b = linear.weight, linear.bias.float()
    if w.dim() == 2:
        return (x @ w.T).float() + b
    return _stacked_linear(x, w).float() + b[..., None, None, :]


class TorchLinear(nn.Module):
    """Linear with torch layout (weight (out, in)) and torch's default
    initialisation U(+-1/sqrt(in)). With `experts=E` the weight is (E, out,
    in) and the layer maps (B, L, in) or (E, B, L, in) to (E, B, L, out);
    with `members=K` too, (K, E, out, in) maps (K, 1, B, L, in) or (K, E,
    B, L, in) to (K, E, B, L, out)."""

    def __init__(self, in_features: int, features: int, experts: int | None = None,
                 generator: torch.Generator | None = None, members: int | None = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        lead = _lead(experts, members)
        self.members = members is not None
        self.weight = _uniform(lead + (features, in_features), bound, generator)
        self.bias = _uniform(lead + (features,), bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dim() == 2:
            return x @ self.weight.T + self.bias
        return _stacked_linear(x, self.weight, self.bias, self.members)


def _stacked_linear(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor | None = None, members: bool = False) -> torch.Tensor:
    """x (B, L, in) shared by every expert or (E, B, L, in); w (E, out, in);
    b (E, out) -> (E, B, L, out), as one batched matrix product. With a
    member axis in front of both, x (K, 1 or E, B, L, in), w (K, E, out,
    in) and b (K, E, out) -> (K, E, B, L, out); a member model's unstacked
    layer, x (K, B, L, in) against w (K, out, in), is the case E = K. No
    bias without b; with `members` in float32 the bias's gradient, and the
    weight gradient of a product into one column, are summed a member at a
    time (`member_broadcast`, `_MemberProduct`)."""
    batch, length, d_in = x.shape[-3:]
    xf = x.reshape(*x.shape[:-3], batch * length, d_in)
    if members and w.shape[-2] == 1 and x.dtype == torch.float32:  # one column
        y = _MemberProduct.apply(xf, w.transpose(-1, -2))
    else:
        y = torch.matmul(xf, w.transpose(-1, -2))
    if b is not None:
        y = _add_broadcast(y, b[..., None, :], members)
    return y.reshape(*y.shape[:-2], batch, length, w.shape[-2])


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with eps 1e-5; with `experts=E` its
    weight and bias carry the leading expert axis. (The JAX package's flax
    LayerNorm names them scale/bias and takes the variance as
    E[x^2] - E[x]^2, which differs from this in the last bits in float32.)
    On bf16 it computes as flax's does: mean and E[x^2] - E[x]^2 (clamped
    at 0) of the widened input in f32, (x - mean) (rsqrt(var + eps) weight)
    + bias in f32, rounded once to bf16."""

    def __init__(self, d_model: int, experts: int | None = None, eps: float = 1e-5,
                 members: int | None = None):
        super().__init__()
        lead = _lead(experts, members)
        self.eps = eps
        self.members = members is not None
        self.weight = nn.Parameter(torch.ones(lead + (d_model,)))
        self.bias = nn.Parameter(torch.zeros(lead + (d_model,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x, or in a bf16 layer the f32 residual sum of `residual`."""
        w, b = self.weight, self.bias
        if w.dim() > 1:  # (E, D) against (E, B, L, D); (K, E, D) against (K, E, B, L, D)
            w, b = w[..., None, None, :], b[..., None, None, :]
        if w.dtype != torch.bfloat16:
            if self.members:
                w, b = member_broadcast(w, x.shape), member_broadcast(b, x.shape)
            return F.layer_norm(x, x.shape[-1:], eps=self.eps) * w + b
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * w.float()
        return ((xf - mean) * mul + b.float()).to(w.dtype)


def residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y, the input of a post-LayerNorm; on bf16 summed in f32 and left
    there, as XLA feeds the JAX package's sum to flax's f32 statistics."""
    if x.dtype != torch.bfloat16:
        return x + y
    return x.float() + y.float()


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` and widened back to f32."""
    return x.to(dtype).float()


def _sum_bf16(z: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over `dim` of bf16 values z (held in f32), summed in f32 and
    rounded once to bf16; returned in f32 with `dim` kept. (XLA on the CPU,
    which runs the JAX package's tests, sums bf16 in windows of 32 with
    every add rounded: the two part by a few roundings of the sum,
    tests/test_torch_bf16_train_ops.py.)"""
    return _round(z.sum(dim=dim, keepdim=True), torch.bfloat16)


class _Bf16Softmax(torch.autograd.Function):
    """`softmax` on bf16. Forward: x - max rounded to bf16, its exp summed
    in f32, the exp s and the sum w each rounded to bf16 and their quotient
    rounded to bf16, or with `final` left in f32. Backward: `jax.nn.softmax`
    is the quotient s / w, which XLA differentiates op by op, each rounding
    to bf16 (a final head's f32 cotangent rounded first):
      dx = (g / w - sum(g w^-2 s)) s,  w^-2 = 1 / (w w)
    with the bf16 terms z = g w^-2 s summed in f32 and rounded once
    (`_sum_bf16`). Its result sums to zero over `dim` in exact arithmetic;
    in bf16 it leaves a residual of the size of one rounding of g / w,
    which the downstream gradients carry."""

    @staticmethod
    def forward(ctx, x, dim, final):
        e = torch.exp((x - x.amax(dim=dim, keepdim=True)).float())
        s = e.to(x.dtype)
        w = e.sum(dim=dim, keepdim=True).to(x.dtype)
        p = s.float() / w.float()
        ctx.save_for_backward(s, w)
        ctx.dim = dim
        return p if final else p.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        s, w = ctx.saved_tensors
        bf = s.dtype
        g, s, w = _round(g, bf), s.float(), w.float()
        w_m2 = _round(1.0 / _round(w * w, bf), bf)
        z = _round(_round(g * w_m2, bf) * s, bf)
        sz = _sum_bf16(z, ctx.dim)
        return (_round(_round(g / w, bf) - sz, bf) * s).to(bf), None, None


def softmax(x: torch.Tensor, dim: int, final: bool = False) -> torch.Tensor:
    """torch.softmax; on bf16, the roundings of the JAX package's
    `jax.nn.softmax` on bf16 as XLA evaluates it: x - max rounded to bf16,
    its exp summed in f32, the exp and the sum each rounded to bf16 and
    their quotient rounded to bf16, or with `final` (an output head) left
    in f32; differentiated as XLA differentiates it (`_Bf16Softmax`)."""
    if x.dtype != torch.bfloat16:
        return torch.softmax(x, dim=dim)
    return _Bf16Softmax.apply(x, dim, final)


class _Bf16Sigmoid(torch.autograd.Function):
    """`sigmoid` on bf16. Forward: 1 / (1 + exp(-x)), every op rounding to
    bf16 but a final head's quotient, which stays f32. Backward: the JVP of
    `lax.logistic`, g y (1 - y) on the rounded bf16 y, every op rounding to
    bf16 (a final head's f32 cotangent rounded first)."""

    @staticmethod
    def forward(ctx, x, final):
        p = 1.0 / (1.0 + torch.exp(-x)).float()
        y = p.to(x.dtype)
        ctx.save_for_backward(y)
        return p if final else y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g.to(y.dtype) * (y * (1.0 - y)), None


def sigmoid(x: torch.Tensor, final: bool = False) -> torch.Tensor:
    """torch.sigmoid; on bf16 the JAX package's `jax.nn.sigmoid` as XLA
    expands it, 1 / (1 + exp(-x)), every op rounding to bf16 but the
    quotient of an output head (`final`), which stays f32; differentiated
    as XLA differentiates `lax.logistic` (`_Bf16Sigmoid`)."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return _Bf16Sigmoid.apply(x, final)


# ---------------------------------------------------------------------------
# LSTM (torch nn.LSTM semantics: stacked, bidirectional, batch_first)
# ---------------------------------------------------------------------------

def _gate_inputs(x, w_ih, b_ih, b_hh, reverse: bool) -> torch.Tensor:
    """Hoisted input projection: (B, L, F) -> time-major (L, B, 4H) gate
    inputs, time-flipped for the reverse direction so the recurrence always
    runs in kernel time order."""
    xw = x @ w_ih.T + b_ih + b_hh
    xw = xw.transpose(0, 1)
    return (torch.flip(xw, dims=(0,)) if reverse else xw).contiguous()


def compute_params(model: nn.Module, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """`model`'s parameters for a forward in `dtype`, by name, for
    `torch.func.functional_call`: each float32 parameter cast to `dtype`
    inside the autograd graph, so that its gradient reaches the f32 master
    through the cast, as the JAX package's `build_epoch_fn` casts its
    parameters inside the loss. An `LSTM`'s parameters stay f32: the layer
    casts them itself (`LSTM._params`), and hands its recurrent weight to
    the LSTM op in f32, which rounds it for its kernels and returns its
    gradient, K2''s f32 sum, in f32, as the JAX package's custom_vjp hands
    it to the f32 master; cast here, autograd would round that gradient to
    bf16."""
    if dtype == torch.float32:
        return dict(model.named_parameters())
    own = {id(p) for m in model.modules() if isinstance(m, LSTM) for p in m.parameters()}
    return {name: p if id(p) in own or p.dtype != torch.float32 else p.to(dtype)
            for name, p in model.named_parameters()}


def _lstm_direction(x, w_ih, w_hh, b_ih, b_hh, reverse: bool) -> torch.Tensor:
    """One direction over (B, L, F) -> (B, L, H): the hoisted projection,
    then the recurrence (`ops.lstm.fused_lstm`: the CUDA kernel on the card,
    the plain loop on the CPU)."""
    ys = fused_lstm(_gate_inputs(x, w_ih, b_ih, b_hh, reverse),
                    w_hh.T.contiguous())
    if reverse:
        ys = torch.flip(ys, dims=(0,))
    return ys.transpose(0, 1)


def _projection(x, w_ih, b_ih, b_hh) -> torch.Tensor:
    """x W_ih^T + b_ih + b_hh: in float32 one fused product with the two
    biases summed first; in bf16 in the JAX package's order of roundings
    (the product, then each bias, each rounded to bf16). K members' weights
    (K, 4H, F) against their inputs (K, B, L, F): one batched product, in
    the same order of roundings."""
    if w_ih.dim() == 3:  # the members' f32 biases: `member_broadcast`
        xf, wt = x.flatten(1, 2), w_ih.transpose(1, 2)
        rows = (xf.shape[0], xf.shape[1], w_ih.shape[1])
        if x.dtype != torch.bfloat16:
            y = torch.baddbmm(member_broadcast((b_ih + b_hh)[:, None], rows), xf, wt)
        else:
            y = torch.bmm(xf, wt) + b_ih[:, None] + b_hh[:, None]
        return y.view(*x.shape[:-1], w_ih.shape[1])
    if x.dtype != torch.bfloat16:
        return F.linear(x, w_ih, b_ih + b_hh)
    return x @ w_ih.T + b_ih + b_hh


class LSTM(nn.Module):
    """Stacked (bi)directional LSTM returning the top layer's per-step
    hidden states, directions concatenated: (B, L, F) -> (B, L, D*H). With
    `members=K` (bidirectional only) every weight leads with K and the
    layer maps (K, B, L, F) to (K, B, L, 2H), each layer's K members in one
    recurrence launch."""

    def __init__(self, input_size: int, hidden_size: int = 128, num_layers: int = 2,
                 bidirectional: bool = True,
                 generator: torch.Generator | None = None, members: int | None = None):
        super().__init__()
        if members is not None and not bidirectional:
            raise ValueError("an LSTM with members is bidirectional")
        lead = _lead(None, members)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.directions = (False, True) if bidirectional else (False,)
        bound = 1.0 / math.sqrt(hidden_size)
        gates = 4 * hidden_size
        for layer in range(num_layers):
            in_features = input_size if layer == 0 else hidden_size * len(self.directions)
            for reverse in self.directions:
                suffix = f"l{layer}" + ("_reverse" if reverse else "")
                setattr(self, f"weight_ih_{suffix}",
                        _uniform(lead + (gates, in_features), bound, generator))
                setattr(self, f"weight_hh_{suffix}",
                        _uniform(lead + (gates, hidden_size), bound, generator))
                setattr(self, f"bias_ih_{suffix}",
                        _uniform(lead + (gates,), bound, generator))
                setattr(self, f"bias_hh_{suffix}",
                        _uniform(lead + (gates,), bound, generator))

    def _params(self, layer: int, reverse: bool, dtype: torch.dtype):
        """(W_ih, W_hh, b_ih, b_hh) of one direction for a forward on `dtype`
        inputs: W_ih and the biases cast to `dtype` (inside the autograd
        graph), W_hh as it is, which the LSTM op rounds to its inputs' dtype
        itself and whose gradient it returns in W_hh's own dtype."""
        suffix = f"l{layer}" + ("_reverse" if reverse else "")
        w_ih, w_hh, b_ih, b_hh = (getattr(self, f"{name}_{suffix}") for name in (
            "weight_ih", "weight_hh", "bias_ih", "bias_hh"))
        return w_ih.to(dtype), w_hh, b_ih.to(dtype), b_hh.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in range(self.num_layers):
            if len(self.directions) == 1:
                x = _lstm_direction(x, *self._params(layer, False, x.dtype), reverse=False)
            else:
                x = _bilstm_layer(x, self._params(layer, False, x.dtype),
                                  self._params(layer, True, x.dtype))
        return x


def _bilstm_layer(x, fwd_params, rev_params) -> torch.Tensor:
    """Both directions of one layer over (B, L, F) -> (B, L, 2H) in one
    two-direction recurrence (`ops.lstm.fused_lstm_bidir`). The reverse
    direction projects the time-flipped input, so its gate inputs come out
    in kernel time order, and the op's concatenation of the two time-major
    views is the one write of the (L, 2B, 4H) gate inputs; the reverse
    hidden states are flipped back. With K members' weights, (K, B, L, F)
    -> (K, B, L, 2H) through one launch over the 2K directions."""
    (wf_ih, wf_hh, bf_ih, bf_hh), (wr_ih, wr_hh, br_ih, br_hh) = fwd_params, rev_params
    xw_f = _projection(x, wf_ih, bf_ih, bf_hh).transpose(-3, -2)
    xw_r = _projection(torch.flip(x, dims=(-2,)), wr_ih, br_ih, br_hh).transpose(-3, -2)
    hs_f, hs_r = fused_lstm_bidir(xw_f, xw_r, wf_hh.transpose(-1, -2),
                                  wr_hh.transpose(-1, -2))
    return torch.cat([hs_f.transpose(-3, -2),
                      torch.flip(hs_r, dims=(-3,)).transpose(-3, -2)], dim=-1)


# ---------------------------------------------------------------------------
# Multi-head self-attention (torch nn.MultiheadAttention semantics)
# ---------------------------------------------------------------------------

class SelfAttention(nn.Module):
    """E stacked multi-head self-attentions: (B, L, D) or (E, B, L, D) ->
    (E, B, L, D); with `experts=None` one attention, (B, L, D) -> (B, L, D),
    run as the stacked computation with E = 1.

    Thin heads (`packed_group_size` gives a pack: MMOECut's dh = 64,
    Choopy's dh = 16): torch's in_proj rows are head-major, so the raw q, k,
    v projections (E*B, L, D) are already the head-packed layout the packed
    kernels read, and their output feeds out_proj with no head split or
    concat. Other heads
    (PLECut's dh = 128): in_proj is read as (E, 3, H, dh, D) and the
    projections land in the per-slice kernels' (E*B, H, L, dh) layout, as
    the JAX package projects them; out_proj contracts (H, dh) as (D, H, dh).
    In training, dropout on the softmax weights runs inside the kernels from
    one seed per expert, drawn in [0, 2^31 - 1) as the JAX package draws it
    (the unstacked attention draws one, as the JAX package's does).

    With `members=K` the parameters are (K, E, ...), the input (K, 1, B, L,
    D) or (K, E, B, L, D), and the K * E stacks run as one: the packed
    kernels take their K * E * B rows in one launch, the per-slice kernels
    their K * E * B * H slices, and each member draws its E seeds from its
    own generator. A member model's unstacked attention (`experts=None`)
    has (K, ...) parameters and maps (K, B, L, D) to (K, B, L, D), each
    member drawing the one seed its own model draws. Members of different
    rates (`dropout` K floats, a `MemberRates`) launch the kernels with
    each row at its member's rate (`RowDropout`); a member at rate 0 draws
    no seed, and its rows are not dropped."""

    part: Part | None = None  # under a parallel layout (`Part`)

    def __init__(self, d_model: int, n_head: int, experts: int | None = None,
                 generator: torch.Generator | None = None,
                 dropout: float | Sequence[float] = 0.0, members: int | None = None):
        super().__init__()
        if d_model % n_head:
            raise ValueError(f"d_model={d_model} not divisible by n_head={n_head}")
        self.d_model = d_model
        self.n_head = n_head
        self.dropout = member_rates(dropout)
        self.pack = packed_group_size(d_model, n_head)
        self.members = members is not None
        self.unstacked_members = members is not None and experts is None
        lead = _lead(experts, members)
        xavier = math.sqrt(6.0 / (3 * d_model + d_model))
        self.in_proj_weight = _uniform(lead + (3 * d_model, d_model), xavier, generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(lead + (3 * d_model,)))
        self.out_proj_weight = _uniform(lead + (d_model, d_model),
                                        1.0 / math.sqrt(d_model), generator)
        self.out_proj_bias = nn.Parameter(torch.zeros(lead + (d_model,)))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        params = (self.in_proj_weight, self.in_proj_bias, self.out_proj_weight,
                  self.out_proj_bias)
        if self.unstacked_members:  # one expert a member: (K, 1, ...)
            return self._stacked(x[:, None], *(p[:, None] for p in params),
                                 generator=generator)[:, 0]
        stacked = self.in_proj_weight.dim() > 2
        out = self._stacked(x, *(p if stacked else p[None] for p in params),
                            generator=generator)
        return out if stacked else out[0]

    def _stacked(self, x, w, b, out_w, out_b, generator) -> torch.Tensor:
        """The attention of E experts with parameters (E, ...) -> (E, B, L, D),
        or of K members' E experts with (K, E, ...) -> (K, E, B, L, D)."""
        d = self.d_model
        lead = w.shape[:-2]
        experts = w.shape[-3]
        batch, length = x.shape[-3:-1]
        heads = self.n_head
        rate = self.dropout if self.training else 0.0
        streams = None
        if drops(rate):
            per = 1 if self.pack else heads  # rows a list
            rows = batch * per  # of an expert
            # under a layout, this rank's experts and rows of the whole stack's
            part = self.part or Part()
            whole, first = part.experts or (experts, 0)
            start = part.rows[1] * per if part.rows else 0

            def seeds_of(g):
                return torch.randint(0, 2**31 - 1, (whole,), generator=g,
                                     device=x.device)[first:first + experts]

            if isinstance(rate, MemberRates):
                seeds = torch.stack([
                    seeds_of(_generator(g)) if r > 0.0
                    else torch.zeros(experts, dtype=torch.int64, device=x.device)
                    for g, r in zip(generator, rate.rates)]).reshape(-1)
                rate = rate.rows(experts * rows)
            else:
                seeds = member_draw(generator, seeds_of).reshape(-1)
            streams = expert_streams(seeds, rows, start)

        if self.pack is None:
            dh = d // heads
            w3 = w.reshape(*lead, 3, heads, dh, d)
            b3 = b.reshape(*lead, 3, 1, heads, 1, dh)
            if x.dim() == len(lead) + 3 and x.shape[-4] == 1:
                x = x.squeeze(-4)  # one input for all the experts
            eq = ("...bld,...ehjd->...ebhlj" if x.dim() == len(lead) + 2
                  else "...ebld,...ehjd->...ebhlj")

            def proj(i):  # -> (prod(lead) * B, H, L, dh), contiguous
                y = _add_broadcast(torch.einsum(eq, x, w3.select(-4, i)), b3.select(-5, i),
                                   self.members)
                return y.reshape(-1, heads, length, dh).contiguous()

            o, _ = fused_attention(proj(0), proj(1), proj(2), dropout_rate=rate,
                                   streams=streams)
            return _add_broadcast(torch.einsum("...bhlj,...dhj->...bld",
                                               o.reshape(*lead, batch, heads, length, dh),
                                               out_w.reshape(*lead, d, heads, dh)),
                                  out_b[..., None, None, :], self.members)

        def proj(i):  # (..., E, B, L, D) -> (... E * B, L, D), contiguous
            y = _stacked_linear(x, w[..., i * d:(i + 1) * d, :], b[..., i * d:(i + 1) * d],
                                self.members)
            return y.reshape(-1, length, d)

        o, _ = fused_attention_packed(proj(0), proj(1), proj(2),
                                      heads=heads, pack=self.pack,
                                      dropout_rate=rate, streams=streams)
        return _stacked_linear(o.reshape(*lead, batch, length, d), out_w, out_b, self.members)


class TransformerEncoderLayer(nn.Module):
    """E stacked torch nn.TransformerEncoderLayer (one with `experts=None`):
    post-LayerNorm, ReLU FFN of width `dim_feedforward`. In training,
    dropout at the JAX package's sites: the attention weights (in the
    kernels), the attention output, the FFN's hidden units (fused with the
    ReLU) and the FFN output. Each mask is drawn over the whole stacked
    (E, B, L, .) tensor, so the experts' masks are independent.

    Under tp (`part.columns`, `parallel/sharding.py`) the layer holds its
    FFN's `linear1` rows and `linear2` columns of the whole FFN: its input
    enters through `copy_to_model`, the partial products of `linear2` are
    summed by `reduce_from_model` and `linear2`'s bias is added once after
    the sum."""

    part: Part | None = None  # under a parallel layout (`Part`)

    def __init__(self, d_model: int, n_head: int, dim_feedforward: int = 2048,
                 experts: int | None = None, generator: torch.Generator | None = None,
                 dropout: float | Sequence[float] = 0.1, members: int | None = None):
        super().__init__()
        self.dropout = member_rates(dropout)
        self.self_attn = SelfAttention(d_model, n_head, experts, generator, dropout,
                                       members)
        self.norm1 = LayerNorm(d_model, experts, members=members)
        self.linear1 = TorchLinear(d_model, dim_feedforward, experts, generator, members)
        self.linear2 = TorchLinear(dim_feedforward, d_model, experts, generator, members)
        self.norm2 = LayerNorm(d_model, experts, members=members)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        part = self.part
        tp = part is not None and part.columns is not None
        attn = self.self_attn(x, generator)
        if drops(rate):
            attn = dropout(attn, rate, generator, part)
        x = self.norm1(residual(x, attn))
        h = self.linear1(copy_to_model(x, part.group) if tp else x)
        h = relu_dropout(h, rate, generator, part) if drops(rate) else torch.relu(h)
        if tp:
            w, b = self.linear2.weight, self.linear2.bias
            h = reduce_from_model(h @ w.T if w.dim() == 2 else _stacked_linear(h, w),
                                  part.group)
            h = h + (b if b.dim() == 1 else b[..., None, None, :])
        else:
            h = self.linear2(h)
        if drops(rate):
            h = dropout(h, rate, generator, part)
        return self.norm2(residual(x, h))


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, n_head: int, num_layers: int,
                 dim_feedforward: int = 2048, experts: int | None = None,
                 generator: torch.Generator | None = None,
                 dropout: float | Sequence[float] = 0.1, members: int | None = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layers_{i}", TransformerEncoderLayer(
                d_model, n_head, dim_feedforward, experts, generator, dropout, members))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x, generator)
        return x


# ---------------------------------------------------------------------------
# Output towers
# ---------------------------------------------------------------------------

def _tower_logits(linear: TorchLinear, x: torch.Tensor,
                  gates: torch.Tensor | None, group=None) -> torch.Tensor:
    """Affine tower head with the MMOE gate mix in LOGIT space: with gates
    (B, E) and x (E, B, L, D), sum_e g_e (x_e W + b) == (sum_e g_e x_e) W + b
    because the gates sum to 1, so the per-expert (B, L, 1) logits are mixed
    instead of (B, L, D) activations. With members: the tower's (K, 1, D)
    weight against (K, E, B, L, D) and gates (K, B, E) -> (K, B, L, 1).
    Under ep (`group`, the model group) x and gates are this rank's experts
    only: the tower's replicated weights enter through `copy_to_model` and
    the partial mixes are summed by `reduce_from_model`."""
    if group is not None:
        w, b = copy_to_model(linear.weight, group), copy_to_model(linear.bias, group)
        return reduce_from_model(torch.einsum("be,eblo->blo", gates, x @ w.T + b), group)
    if linear.weight.dim() == 3:  # one tower for a member's E experts
        k, e = x.shape[:2]
        w = member_broadcast(linear.weight[:, None], (k, e, 1, x.shape[-1]))
        logits = _stacked_linear(x, w, member_broadcast(linear.bias[:, None], (k, e, 1)), True)
        return torch.einsum("kbe,keblo->kblo", gates, logits)
    logits = linear(x)
    if gates is not None:
        logits = torch.einsum("be,eblo->blo", gates, logits)
    return logits


class _Tower(nn.Module):
    def __init__(self, d_model: int, generator: torch.Generator | None = None,
                 members: int | None = None):
        super().__init__()
        self.linear = TorchLinear(d_model, 1, generator=generator, members=members)


class TowerCut(_Tower):
    """Linear -> softmax over positions: a cut distribution (B, L, 1)."""

    def forward(self, x, gates=None, group=None):
        return softmax(_tower_logits(self.linear, x, gates, group), dim=-2, final=True)


class TowerClass(_Tower):
    """Linear -> sigmoid: per-position relevance probability (B, L, 1)."""

    def forward(self, x, gates=None, group=None):
        return sigmoid(_tower_logits(self.linear, x, gates, group), final=True)


class TowerRerank(_Tower):
    """Linear -> softmax over positions: rerank score distribution (B, L, 1)."""

    def forward(self, x, gates=None, group=None):
        return softmax(_tower_logits(self.linear, x, gates, group), dim=-2, final=True)
