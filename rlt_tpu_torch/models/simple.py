"""Single-task truncation models in PyTorch: BiCut, Choopy and AttnCut.

The counterparts of the JAX package's `models/simple.py::BiCut`,
`::Choopy` and `::AttnCut`, with its parameter names and layouts:

- BiCut (reference models/Bicut.py:5-21): `bilstm` (2-layer BiLSTM,
  H = 128), `fc` (Linear 256 -> 256), ReLU, `decision` (Linear 256 -> 2),
  dropout on the logits in training, softmax over the decision pair:
  (B, L, 2) per-position {truncate, continue} probabilities. It runs the
  LSTM kernels only.
- Choopy (reference models/Choopy.py:6-23): a learned position encoding
  `position_encoding` (L, d_model - 1) drawn from N(0, 1), concatenated
  after the score (F = 1) to d_model = 128, `attention_layer` (three
  unstacked post-LN encoder layers of 8 heads), `decision` (Linear
  128 -> 1), softmax over positions: a (B, L, 1) cut distribution. Its
  heads of dh = 16 run the head-packed attention kernels in one group of
  pack 8, one launch per layer.
- AttnCut (reference models/AttnCut.py:5-20): `encoding_layer` (the
  BiLSTM), `attention_layer` (one unstacked post-LN encoder layer of 4
  heads, d_model 256), `decision` (Linear 256 -> 1), softmax over
  positions: a (B, L, 1) cut distribution. Its heads of dh = 64 run the
  head-packed attention kernels on the (B, L, D) batch.

The training forward (`model.train()`) with a dropout rate above 0 draws
every mask from the `torch.Generator` passed to `forward`.

With `members=K` each is K models in one (population training,
`rlt_tpu_torch/population.py`): every parameter leads with the member axis
(Choopy's `position_encoding` is (K, L, d_model - 1)), the input is (K, B,
L, F), the output leads with K, and the training forward takes K
generators, member m drawing from generator m what its own model draws.
`dropout` may then be K rates, one a member (`layers.MemberRates`), each
member dropping at its own. `models.build_population_model` fills it from
K seeded models.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rlt_tpu_torch.models.layers import (
    LSTM,
    Part,
    TorchLinear,
    TransformerEncoder,
    dropout,
    drops,
    member_broadcast,
    member_rates,
    softmax,
)


class BiCut(nn.Module):
    part: Part | None = None  # under a parallel layout: the data rank's rows

    def __init__(self, input_size: int = 3, lstm_hidden_size: int = 128,
                 lstm_layers: int = 2, fc_dimensions: int = 256,
                 dropout: float | Sequence[float] = 0.4, seed: int = 0,
                 members: int | None = None):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.dropout = member_rates(dropout)
        self.bilstm = LSTM(input_size, lstm_hidden_size, lstm_layers, generator=g,
                           members=members)
        self.fc = TorchLinear(2 * lstm_hidden_size, fc_dimensions, generator=g,
                              members=members)
        self.decision = TorchLinear(fc_dimensions, 2, generator=g, members=members)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        logits = self.decision(torch.relu(self.fc(self.bilstm(x))))
        rate = self.dropout if self.training else 0.0
        if drops(rate):
            # the reference drops logits, before the softmax
            logits = dropout(logits, rate, generator, self.part)
        return softmax(logits, dim=-1, final=True)


class Choopy(nn.Module):
    def __init__(self, seq_len: int = 300, d_model: int = 128, n_head: int = 8,
                 num_layers: int = 3, dropout: float | Sequence[float] = 0.2, seed: int = 0,
                 members: int | None = None):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        lead = () if members is None else (members,)
        self.position_encoding = nn.Parameter(
            torch.randn(lead + (seq_len, d_model - 1), generator=g))
        self.attention_layer = TransformerEncoder(d_model, n_head, num_layers,
                                                  generator=g, dropout=dropout,
                                                  members=members)
        self.decision = TorchLinear(d_model, 1, generator=g, members=members)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = self.attention_layer(with_position_encoding(x, self.position_encoding),
                                 generator)
        return softmax(self.decision(x), dim=-2, final=True)


def with_position_encoding(x: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    """(B, L, 1) scores and the (L, d_model - 1) encoding -> (B, L, d_model):
    each list's scores, then the encoding shared by every list (both bf16
    in a model cast to bf16, as the JAX package casts the encoding with the
    parameters). With members, (K, B, L, 1) and (K, L, d_model - 1) -> (K,
    B, L, d_model), member m's encoding shared by its lists."""
    shape = (*x.shape[:-1], pe.shape[-1])
    return torch.cat([x, member_broadcast(pe.unsqueeze(-3), shape) if pe.dim() == 3
                      else pe.unsqueeze(-3).expand(shape)], dim=-1)


class AttnCut(nn.Module):
    def __init__(self, input_size: int = 3, d_model: int = 256, n_head: int = 4,
                 num_layers: int = 1, dropout: float | Sequence[float] = 0.4, seed: int = 0,
                 members: int | None = None):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.encoding_layer = LSTM(input_size, 128, 2, generator=g, members=members)
        self.attention_layer = TransformerEncoder(d_model, n_head, num_layers,
                                                  generator=g, dropout=dropout,
                                                  members=members)
        self.decision = TorchLinear(d_model, 1, generator=g, members=members)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = self.attention_layer(self.encoding_layer(x), generator)
        return softmax(self.decision(x), dim=-2, final=True)
