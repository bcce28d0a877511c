"""Representation-probing modules of the verification harnesses (the JAX
package's `models/probe.py`; the reference's models/Probe.py,
Classification.py and Rerank.py), with its parameter names and layouts.

- `ProbeBase`: a 2-expert MMOECut (reference Probe.py:56-99) whose forward
  also returns its intermediates: (experts_in, experts_o, heads), the
  BiLSTM output (B, L, 2H), the experts' outputs (2, B, L, D) and the task
  heads. Its experts run the packed attention kernels K5'/K6' over the
  2 * B rows of the expert stack, its BiLSTM K1'/K2'. Its gates `w_gates`
  (T, 2 * H * L, 2) are drawn from N(0, 1), the JAX module's `randn_init`.
- `Probe`: six towers (reference Probe.py:102-123), a classification and a
  rerank tower on the BiLSTM output and on each expert's output.
- `TaskC` / `TaskR`: one linear layer to one logit a position, then a
  sigmoid (classification) or a softmax over positions (rerank), the heads
  of verify_bmt (reference Classification.py:3-13, Rerank.py:3-13).
"""

from __future__ import annotations

import torch
from torch import nn

from rlt_tpu_torch.models.layers import (
    TorchLinear,
    TowerClass,
    TowerRerank,
    sigmoid,
    softmax,
)
from rlt_tpu_torch.models.mmoe import MMOECut


class ProbeBase(MMOECut):
    """MMOECut of `num_experts` (2) experts that returns (experts_in,
    experts_o, heads); the last head is the cut distribution."""

    def __init__(self, seq_len: int = 300, num_experts: int = 2, num_tasks: float = 3,
                 input_size: int = 3, encoding_size: int = 128, d_model: int = 256,
                 n_head: int = 4, num_layers: int = 1, dropout: float = 0.2,
                 seed: int = 0):
        super().__init__(seq_len=seq_len, num_experts=num_experts, num_tasks=num_tasks,
                         input_size=input_size, encoding_size=encoding_size,
                         d_model=d_model, n_head=n_head, num_layers=num_layers,
                         dropout=dropout, seed=seed)

    def forward(self, x: torch.Tensor, generator=None):
        experts_in = self.pre_encoding(x)  # (B, L, 2H)
        experts_o = self.experts(experts_in, generator)  # (E, B, L, D)
        return experts_in, experts_o, self.heads(experts_in, experts_o)


class Probe(nn.Module):
    """Six probe towers on a frozen ProbeBase's intermediates; returns
    (c1, r1, ce1, ce2, re1, re2), each (B, L, 1)."""

    def __init__(self, encoding_size: int = 128, d_model: int = 256, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        width = 2 * encoding_size  # the BiLSTM output
        self.probe_c1 = TowerClass(width, g)
        self.probe_r1 = TowerRerank(width, g)
        self.probe_ce1 = TowerClass(d_model, g)
        self.probe_ce2 = TowerClass(d_model, g)
        self.probe_re1 = TowerRerank(d_model, g)
        self.probe_re2 = TowerRerank(d_model, g)

    def forward(self, experts_in: torch.Tensor, experts_o: torch.Tensor):
        return (self.probe_c1(experts_in), self.probe_r1(experts_in),
                self.probe_ce1(experts_o[0]), self.probe_ce2(experts_o[1]),
                self.probe_re1(experts_o[0]), self.probe_re2(experts_o[1]))


class TaskC(nn.Module):
    """Standalone classification head: (B, L, F) -> sigmoid logits (B, L, 1)."""

    def __init__(self, in_features: int, seed: int = 0):
        super().__init__()
        self.linear = TorchLinear(in_features, 1, generator=torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sigmoid(self.linear(x), final=True)


class TaskR(nn.Module):
    """Standalone rerank head: (B, L, F) -> softmax over positions (B, L, 1)."""

    def __init__(self, in_features: int, seed: int = 0):
        super().__init__()
        self.linear = TorchLinear(in_features, 1, generator=torch.Generator().manual_seed(seed))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return softmax(self.linear(x), dim=-2, final=True)
