"""Shared-bottom multi-task truncation models in PyTorch: MtChoopy and
MtAttnCut.

The counterparts of the JAX package's `models/multitask.py::MtChoopy`
(reference models/MtChoopy.py:5-32) and `::MtAttnCut` (reference
models/MtAttnCut.py:4-29). MtChoopy is Choopy's trunk: `position_encoding`
(L, 127) after the score, `encoding_layer` (three unstacked post-LN encoder
layers of 8 heads of dh = 16, d_model 128). MtAttnCut's is `pre_encoding`
(2-layer BiLSTM, H = 128) and `encoding_layer` (one unstacked post-LN
encoder layer of 4 heads, d_model 256). Both encoders run the head-packed
attention kernels. Then `heads` with `classi` (Linear + sigmoid), `rerank`
(plain Linear) and `decision` (Linear + softmax over positions). num_tasks
picks the heads returned: 3 -> [class, rerank, cut], 2.1 -> [class, cut],
2.2 -> [rerank, cut]; the last is the cut distribution. With `members=K`
each is K models in one, as `models/simple.py`'s models are, `dropout`
one rate or K.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rlt_tpu_torch.models.layers import (
    LSTM,
    TorchLinear,
    TransformerEncoder,
    final_linear,
    sigmoid,
    softmax,
)
from rlt_tpu_torch.models.simple import with_position_encoding


def select_heads(y_class, y_rerank, y_cut, num_tasks: float) -> list:
    if num_tasks == 3:
        return [y_class, y_rerank, y_cut]
    if num_tasks == 2.1:
        return [y_class, y_cut]
    return [y_rerank, y_cut]


class _MtHeads(nn.Module):
    def __init__(self, d_model: int, generator: torch.Generator | None = None,
                 members: int | None = None):
        super().__init__()
        self.classi = TorchLinear(d_model, 1, generator=generator, members=members)
        self.rerank = TorchLinear(d_model, 1, generator=generator, members=members)
        self.decision = TorchLinear(d_model, 1, generator=generator, members=members)

    def forward(self, x: torch.Tensor):
        return (sigmoid(self.classi(x), final=True), final_linear(self.rerank, x),
                softmax(self.decision(x), dim=-2, final=True))


class MtChoopy(nn.Module):
    def __init__(self, seq_len: int = 300, d_model: int = 128, n_head: int = 8,
                 num_layers: int = 3, num_tasks: float = 3,
                 dropout: float | Sequence[float] = 0.4, seed: int = 0,
                 members: int | None = None):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.num_tasks = num_tasks
        lead = () if members is None else (members,)
        self.position_encoding = nn.Parameter(
            torch.randn(lead + (seq_len, d_model - 1), generator=g))
        self.encoding_layer = TransformerEncoder(d_model, n_head, num_layers,
                                                 generator=g, dropout=dropout,
                                                 members=members)
        self.heads = _MtHeads(d_model, g, members)

    def forward(self, x: torch.Tensor, generator=None) -> list[torch.Tensor]:
        x = self.encoding_layer(with_position_encoding(x, self.position_encoding),
                                generator)
        return select_heads(*self.heads(x), self.num_tasks)


class MtAttnCut(nn.Module):
    def __init__(self, input_size: int = 3, d_model: int = 256, n_head: int = 4,
                 num_layers: int = 1, num_tasks: float = 3,
                 dropout: float | Sequence[float] = 0.4, seed: int = 0,
                 members: int | None = None):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.num_tasks = num_tasks
        self.pre_encoding = LSTM(input_size, 128, 2, generator=g, members=members)
        self.encoding_layer = TransformerEncoder(d_model, n_head, num_layers,
                                                 generator=g, dropout=dropout,
                                                 members=members)
        self.heads = _MtHeads(d_model, g, members)

    def forward(self, x: torch.Tensor, generator=None) -> list[torch.Tensor]:
        x = self.encoding_layer(self.pre_encoding(x), generator)
        return select_heads(*self.heads(x), self.num_tasks)
