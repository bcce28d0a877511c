"""MMOECut, the multi-gate mixture-of-experts truncation model, in PyTorch.

The counterpart of the JAX package's `models/mmoe.py::MMOECut`: a 2-layer
BiLSTM pre-encoding of the ranked list, E transformer-encoder experts run as
one stacked (E, B, L, D) computation (the JAX package's `nn.vmap` over
experts; here a leading expert axis on every expert weight), per-task
softmax gates from one (B, F) x (T, F, E) contraction over the flattened
BiLSTM output (F = 2 * 128 * L, so the model is specialised to L), and
towers that mix the experts in logit space. MOECut and PLECut are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from rlt_tpu_torch.models.layers import (
    LSTM,
    TowerClass,
    TowerCut,
    TowerRerank,
    TransformerEncoder,
)


class ExpertStack(nn.Module):
    """E experts, each a transformer encoder of `num_layers` layers, as one
    stacked module: (B, L, D) shared input -> (E, B, L, D). The counterpart
    of the JAX package's `Expert` under `expert_stack`'s `nn.vmap`."""

    def __init__(self, num_experts: int, d_model: int = 256, n_head: int = 4,
                 num_layers: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        self.attention_layer = TransformerEncoder(
            d_model, n_head, num_layers, experts=num_experts, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention_layer(x)


def make_towers(num_tasks: float, d_model: int,
                generator: torch.Generator | None = None) -> dict[str, nn.Module]:
    """Towers by num_tasks, in output order (reference MMOECut.py:69-84)."""
    if num_tasks == 3:
        names = (("tower_class", TowerClass), ("tower_rerank", TowerRerank),
                 ("tower_cut", TowerCut))
    elif num_tasks == 2.1:
        names = (("tower_class", TowerClass), ("tower_cut", TowerCut))
    else:
        names = (("tower_rerank", TowerRerank), ("tower_cut", TowerCut))
    return {name: cls(d_model, generator) for name, cls in names}


class MMOECut(nn.Module):
    """Multi-gate mixture-of-experts (reference MMOECut.py:56-110). Returns
    the task heads as a list of (B, L, 1) tensors; the last is the cut
    distribution. Eval forward only: call `.eval()` first."""

    def __init__(self, seq_len: int = 300, num_experts: int = 3,
                 num_tasks: float = 3, input_size: int = 3,
                 encoding_size: int = 128, d_model: int = 256, n_head: int = 4,
                 num_layers: int = 1, dropout: float = 0.2, seed: int = 0):
        super().__init__()
        if d_model != 2 * encoding_size:
            raise ValueError(f"d_model={d_model} must be twice the BiLSTM "
                             f"encoding_size={encoding_size}")
        g = torch.Generator().manual_seed(seed)
        self.dropout = dropout
        self.pre_encoding = LSTM(input_size, encoding_size, 2, generator=g)
        self.experts = ExpertStack(num_experts, d_model, n_head, num_layers, g)
        n_gates = int(num_tasks)
        w_gates = torch.empty(n_gates, encoding_size * seq_len * 2, num_experts)
        self.w_gates = nn.Parameter(w_gates.normal_(generator=g))
        self.tower_names = []
        for name, tower in make_towers(num_tasks, d_model, g).items():
            self.add_module(name, tower)
            self.tower_names.append(name)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        if self.training and self.dropout > 0.0:
            raise NotImplementedError(
                "MMOECut: the training forward (dropout) is not ported yet "
                "(ROADMAP.md); call .eval() to serve")
        experts_in = self.pre_encoding(x)  # (B, L, 2H)
        return self.heads(experts_in, self.experts(experts_in))

    def heads(self, experts_in: torch.Tensor,
              experts_o: torch.Tensor) -> list[torch.Tensor]:
        """Gates and towers: BiLSTM output (B, L, 2H) and expert outputs
        (E, B, L, D) -> the task heads."""
        flat = experts_in.reshape(experts_in.shape[0], -1)  # (B, 2*H*L)
        gates = torch.softmax(torch.einsum("bf,tfe->tbe", flat, self.w_gates), dim=-1)
        return [getattr(self, name)(experts_o, gates=gates[t])
                for t, name in enumerate(self.tower_names)]
