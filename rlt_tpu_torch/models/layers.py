"""Shared layers of the port, with torch-matching semantics and layouts.

The counterpart of the JAX package's `models/layers.py` for what MMOECut
serving runs: `TorchLinear`, the stacked bidirectional `LSTM` over the
ranked list, multi-head `SelfAttention`, the post-LayerNorm
`TransformerEncoderLayer` (eps 1e-5, ReLU FFN of width 2048),
`TransformerEncoder`, and the towers with the logit-space expert mix.

Parameter names and layouts match the JAX package's (and so torch's):
LSTM `weight_ih_l{n}[_reverse]` (4H, F) in gate order i, f, g, o; Linear
weight (out, in); attention `in_proj_weight` rows [q; k; v], each block
head-major. The JAX package runs its experts under `nn.vmap`, which gives
every expert parameter a leading axis E. Here the encoder layers keep that
axis (`experts=E`) and run the E experts as one batched computation on
(E, B, L, D) activations; a (B, L, D) input is shared by every expert.

Only the deterministic (serving) forward is ported: dropout is off at eval,
and the training forward with its dropout is the next slice's work
(ROADMAP.md). Initial values follow the torch distributions the JAX
package reproduces, drawn from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from rlt_tpu_torch.ops.attention import fused_attention_packed, packed_group_size
from rlt_tpu_torch.ops.lstm import fused_lstm


def _uniform(shape, bound: float, generator: torch.Generator | None) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(t)


def _lead(experts: int | None) -> tuple:
    return () if experts is None else (experts,)


class TorchLinear(nn.Module):
    """Linear with torch layout (weight (out, in)) and torch's default
    initialisation U(+-1/sqrt(in)). With `experts=E` the weight is (E, out,
    in) and the layer maps (B, L, in) or (E, B, L, in) to (E, B, L, out)."""

    def __init__(self, in_features: int, features: int, experts: int | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        lead = _lead(experts)
        self.weight = _uniform(lead + (features, in_features), bound, generator)
        self.bias = _uniform(lead + (features,), bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dim() == 2:
            return x @ self.weight.T + self.bias
        return _stacked_linear(x, self.weight, self.bias)


def _stacked_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B, L, in) shared by every expert or (E, B, L, in); w (E, out, in);
    b (E, out) -> (E, B, L, out), as one batched matrix product."""
    batch, length, d_in = x.shape[-3:]
    xf = x.reshape(*x.shape[:-3], batch * length, d_in)
    y = torch.matmul(xf, w.transpose(1, 2)) + b[:, None]
    return y.reshape(w.shape[0], batch, length, w.shape[1])


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with eps 1e-5; with `experts=E` its
    weight and bias carry the leading expert axis. (The JAX package's flax
    LayerNorm names them scale/bias and takes the variance as
    E[x^2] - E[x]^2, which differs from this in the last bits.)"""

    def __init__(self, d_model: int, experts: int | None = None, eps: float = 1e-5):
        super().__init__()
        lead = _lead(experts)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(lead + (d_model,)))
        self.bias = nn.Parameter(torch.zeros(lead + (d_model,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x, x.shape[-1:], eps=self.eps)
        if self.weight.dim() == 1:
            return y * self.weight + self.bias
        return y * self.weight[:, None, None] + self.bias[:, None, None]


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


def _lstm_direction(x, w_ih, w_hh, b_ih, b_hh, reverse: bool) -> torch.Tensor:
    """One direction over (B, L, F) -> (B, L, H): the hoisted projection,
    then the recurrence (`ops.lstm.fused_lstm`: the CUDA kernel on the card,
    the plain loop on the CPU)."""
    ys = fused_lstm(_gate_inputs(x, w_ih, b_ih, b_hh, reverse),
                    w_hh.T.contiguous())
    if reverse:
        ys = torch.flip(ys, dims=(0,))
    return ys.transpose(0, 1)


class LSTM(nn.Module):
    """Stacked (bi)directional LSTM returning the top layer's per-step
    hidden states, directions concatenated: (B, L, F) -> (B, L, D*H)."""

    def __init__(self, input_size: int, hidden_size: int = 128, num_layers: int = 2,
                 bidirectional: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
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
                        _uniform((gates, in_features), bound, generator))
                setattr(self, f"weight_hh_{suffix}",
                        _uniform((gates, hidden_size), bound, generator))
                setattr(self, f"bias_ih_{suffix}", _uniform((gates,), bound, generator))
                setattr(self, f"bias_hh_{suffix}", _uniform((gates,), bound, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in range(self.num_layers):
            outs = []
            for reverse in self.directions:
                suffix = f"l{layer}" + ("_reverse" if reverse else "")
                outs.append(_lstm_direction(
                    x, getattr(self, f"weight_ih_{suffix}"),
                    getattr(self, f"weight_hh_{suffix}"),
                    getattr(self, f"bias_ih_{suffix}"),
                    getattr(self, f"bias_hh_{suffix}"), reverse))
            x = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
        return x


# ---------------------------------------------------------------------------
# Multi-head self-attention (torch nn.MultiheadAttention semantics)
# ---------------------------------------------------------------------------

class SelfAttention(nn.Module):
    """E stacked multi-head self-attentions: (B, L, D) or (E, B, L, D) ->
    (E, B, L, D).

    torch's in_proj rows are head-major, so the raw q, k, v projections
    (E*B, L, D) are already the head-packed layout the attention kernel
    reads, and its output feeds out_proj with no head split or concat."""

    def __init__(self, d_model: int, n_head: int, experts: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.d_model = d_model
        self.n_head = n_head
        self.pack = packed_group_size(d_model, n_head)
        if self.pack is None:
            raise NotImplementedError(
                f"d_model={d_model} with {n_head} heads needs the per-slice "
                "attention kernel, which is not ported yet (ROADMAP.md)")
        xavier = math.sqrt(6.0 / (3 * d_model + d_model))
        self.in_proj_weight = _uniform((experts, 3 * d_model, d_model), xavier, generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(experts, 3 * d_model))
        self.out_proj_weight = _uniform((experts, d_model, d_model),
                                        1.0 / math.sqrt(d_model), generator)
        self.out_proj_bias = nn.Parameter(torch.zeros(experts, d_model))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.d_model
        experts = self.in_proj_weight.shape[0]
        batch, length = x.shape[-3:-1]
        w, b = self.in_proj_weight, self.in_proj_bias

        def proj(i):  # (E, B, L, D) -> (E*B, L, D), contiguous
            y = _stacked_linear(x, w[:, i * d:(i + 1) * d], b[:, i * d:(i + 1) * d])
            return y.reshape(experts * batch, length, d)

        o, _ = fused_attention_packed(proj(0), proj(1), proj(2),
                                      heads=self.n_head, pack=self.pack)
        return _stacked_linear(o.reshape(experts, batch, length, d),
                               self.out_proj_weight, self.out_proj_bias)


class TransformerEncoderLayer(nn.Module):
    """E stacked torch nn.TransformerEncoderLayer: post-LayerNorm, ReLU FFN
    of width `dim_feedforward`, at eval (no dropout)."""

    def __init__(self, d_model: int, n_head: int, dim_feedforward: int = 2048,
                 experts: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        self.self_attn = SelfAttention(d_model, n_head, experts, generator)
        self.norm1 = LayerNorm(d_model, experts)
        self.linear1 = TorchLinear(d_model, dim_feedforward, experts, generator)
        self.linear2 = TorchLinear(dim_feedforward, d_model, experts, generator)
        self.norm2 = LayerNorm(d_model, experts)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x))
        h = torch.relu(self.linear1(x))
        return self.norm2(x + self.linear2(h))


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, n_head: int, num_layers: int,
                 dim_feedforward: int = 2048, experts: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layers_{i}", TransformerEncoderLayer(
                d_model, n_head, dim_feedforward, experts, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
        return x


# ---------------------------------------------------------------------------
# Output towers
# ---------------------------------------------------------------------------

def _tower_logits(linear: TorchLinear, x: torch.Tensor,
                  gates: torch.Tensor | None) -> torch.Tensor:
    """Affine tower head with the MMOE gate mix in LOGIT space: with gates
    (B, E) and x (E, B, L, D), sum_e g_e (x_e W + b) == (sum_e g_e x_e) W + b
    because the gates sum to 1, so the per-expert (B, L, 1) logits are mixed
    instead of (B, L, D) activations."""
    logits = linear(x)
    if gates is not None:
        logits = torch.einsum("be,eblo->blo", gates, logits)
    return logits


class _Tower(nn.Module):
    def __init__(self, d_model: int, generator: torch.Generator | None = None):
        super().__init__()
        self.linear = TorchLinear(d_model, 1, generator=generator)


class TowerCut(_Tower):
    """Linear -> softmax over positions: a cut distribution (B, L, 1)."""

    def forward(self, x, gates=None):
        return torch.softmax(_tower_logits(self.linear, x, gates), dim=1)


class TowerClass(_Tower):
    """Linear -> sigmoid: per-position relevance probability (B, L, 1)."""

    def forward(self, x, gates=None):
        return torch.sigmoid(_tower_logits(self.linear, x, gates))


class TowerRerank(_Tower):
    """Linear -> softmax over positions: rerank score distribution (B, L, 1)."""

    def forward(self, x, gates=None):
        return torch.softmax(_tower_logits(self.linear, x, gates), dim=1)
