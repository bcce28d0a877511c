"""Mixture-of-experts truncation models in PyTorch: MMOECut, MOECut and
PLECut.

The counterparts of the JAX package's `models/mmoe.py::MMOECut`, `::MOECut`
and `::PLECut`: a 2-layer BiLSTM pre-encoding of the ranked list, E
transformer-encoder experts run as one stacked (E, B, L, D) computation (the
JAX package's `nn.vmap` over experts; here a leading expert axis on every
expert weight), softmax gates over the flattened BiLSTM output
(F = 2 * 128 * L, so the models are specialised to L), and towers that mix
the experts in logit space. MMOECut gates every task over all experts with
one (B, F) x (T, F, E) contraction; MOECut has one shared (F, E) gate that
every tower takes; PLECut gates each of its three fixed towers over its own
subset of the three experts. The training forward (`model.train()`) applies
dropout in the experts and draws every mask from the `torch.Generator`
passed to `forward`. Cast to bf16, the gates (their contraction and
softmax) and the towers' logit mix run in bf16 as the JAX package's do.

`MMOECut(members=K)` is K MMOECuts as one module (population training,
`rlt_tpu_torch/population.py`), and so are `MOECut(members=K)` and
`PLECut(members=K)`: every parameter leads with the member axis, the input
is (K, B, L, F), the heads (K, B, L, 1), the two BiLSTM layers launch K1'
once each over the 2K directions, and the expert stack runs its K * E
experts as one stack: K * E * B attention rows in the packed kernels, K * E
* B * H slices in PLECut's per-slice kernels. Its training forward takes K
generators, one per member, and `dropout` may be K rates, one a member
(`layers.MemberRates`: each row of the attention kernels at its member's
rate).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from rlt_tpu_torch.models.layers import (
    LSTM,
    Part,
    TowerClass,
    TowerCut,
    TowerRerank,
    TransformerEncoder,
    softmax,
)
from rlt_tpu_torch.parallel.functional import copy_to_model


class ExpertStack(nn.Module):
    """E experts, each a transformer encoder of `num_layers` layers, as one
    stacked module: (B, L, D) shared input -> (E, B, L, D). The counterpart
    of the JAX package's `Expert` under `expert_stack`'s `nn.vmap`. Under
    ep (`part.experts`, `parallel/sharding.py`) it holds E / m of the
    experts, and its input enters through `copy_to_model`."""

    part: Part | None = None  # under a parallel layout (`layers.Part`)

    def __init__(self, num_experts: int, d_model: int = 256, n_head: int = 4,
                 num_layers: int = 1, generator: torch.Generator | None = None,
                 dropout: float | Sequence[float] = 0.2, members: int | None = None):
        super().__init__()
        self.members = members
        self.attention_layer = TransformerEncoder(
            d_model, n_head, num_layers, experts=num_experts, generator=generator,
            dropout=dropout, members=members)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """(B, L, D) -> (E, B, L, D); with members (K, B, L, D), each
        member's input shared by its experts, -> (K, E, B, L, D)."""
        if self.members is not None:
            x = x[:, None]
        if _ep(self.part):
            x = copy_to_model(x, self.part.group)
        return self.attention_layer(x, generator)


def local_gate(gate: torch.Tensor, part: Part, lo: int, n: int):
    """Under ep (`part.experts` = (E, first), n experts held here), a
    tower's gate over the experts lo..lo + E' - 1 cut to the experts held
    here, entered through `copy_to_model`, and the slice of this rank's
    expert outputs that they mix (empty where the tower mixes none held
    here)."""
    first = part.experts[1]
    start = max(lo, first)
    stop = max(min(lo + gate.shape[-1], first + n), start)
    return (copy_to_model(gate, part.group)[..., start - lo:stop - lo],
            slice(start - first, stop - first))


def _ep(part: Part | None) -> bool:
    return part is not None and part.experts is not None


def make_towers(num_tasks: float, d_model: int, generator: torch.Generator | None = None,
                members: int | None = None) -> dict[str, nn.Module]:
    """Towers by num_tasks, in output order (reference MMOECut.py:69-84)."""
    if num_tasks == 3:
        names = (("tower_class", TowerClass), ("tower_rerank", TowerRerank),
                 ("tower_cut", TowerCut))
    elif num_tasks == 2.1:
        names = (("tower_class", TowerClass), ("tower_cut", TowerCut))
    else:
        names = (("tower_rerank", TowerRerank), ("tower_cut", TowerCut))
    return {name: cls(d_model, generator, members) for name, cls in names}


class MMOECut(nn.Module):
    """Multi-gate mixture-of-experts (reference MMOECut.py:56-110). Returns
    the task heads as a list of (B, L, 1) tensors; the last is the cut
    distribution. In training mode with dropout above 0, `forward` needs a
    `torch.Generator` on the input's device for the dropout masks. With
    `members=K` it is K models in one, each member's
    parameters in slice m of every leaf, (K, B, L, F) -> (K, B, L, 1) heads,
    K generators in training; `build_population_model` fills it from K
    seeded models. Under ep (`part`, `parallel/sharding.py`) the towers mix
    the experts held here and sum the partial mixes over the model group."""

    part: Part | None = None  # under a parallel layout (`layers.Part`)

    def __init__(self, seq_len: int = 300, num_experts: int = 3,
                 num_tasks: float = 3, input_size: int = 3,
                 encoding_size: int = 128, d_model: int = 256, n_head: int = 4,
                 num_layers: int = 1, dropout: float | Sequence[float] = 0.2, seed: int = 0,
                 members: int | None = None):
        super().__init__()
        if d_model != 2 * encoding_size:
            raise ValueError(f"d_model={d_model} must be twice the BiLSTM "
                             f"encoding_size={encoding_size}")
        g = torch.Generator().manual_seed(seed)
        self.pre_encoding = LSTM(input_size, encoding_size, 2, generator=g,
                                 members=members)
        self.experts = ExpertStack(num_experts, d_model, n_head, num_layers, g,
                                   dropout, members)
        w_gates = torch.empty((() if members is None else (members,)) + self._gates_shape(
            num_tasks, encoding_size * seq_len * 2, num_experts))
        self.w_gates = nn.Parameter(w_gates.normal_(generator=g))
        self.tower_names = []
        for name, tower in make_towers(num_tasks, d_model, g, members).items():
            self.add_module(name, tower)
            self.tower_names.append(name)

    def forward(self, x: torch.Tensor, generator=None) -> list[torch.Tensor]:
        experts_in = self.pre_encoding(x)  # (B, L, 2H), or (K, B, L, 2H)
        return self.heads(experts_in, self.experts(experts_in, generator))

    @staticmethod
    def _gates_shape(num_tasks: float, features: int, num_experts: int) -> tuple:
        return (int(num_tasks), features, num_experts)  # one gate per task

    def gates(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """Each tower's (B, E) gate from the flattened BiLSTM output; with
        members (K, B, E) from (K, B, F)."""
        eq = "bf,tfe->tbe" if self.w_gates.dim() == 3 else "kbf,ktfe->tkbe"
        return list(softmax(torch.einsum(eq, flat, self.w_gates), dim=-1))

    def heads(self, experts_in: torch.Tensor,
              experts_o: torch.Tensor) -> list[torch.Tensor]:
        """Gates and towers: BiLSTM output (B, L, 2H) and expert outputs
        (E, B, L, D) -> the task heads; with members (K, B, L, 2H) and
        (K, E, B, L, D) -> (K, B, L, 1) heads."""
        flat = experts_in.flatten(-2)  # (B, 2*H*L), or (K, B, 2*H*L)
        if not _ep(self.part):
            return [getattr(self, name)(experts_o, gates=gate)
                    for gate, name in zip(self.gates(flat), self.tower_names)]
        heads = []
        for gate, name in zip(self.gates(flat), self.tower_names):
            gate, held = local_gate(gate, self.part, 0, experts_o.shape[-4])
            heads.append(getattr(self, name)(experts_o[held], gates=gate,
                                             group=self.part.group))
        return heads


class MOECut(MMOECut):
    """MMOECut with one shared gate (reference MOECut.py:56-109): `w_gates`
    is (2 * H * L, E) and softmax(flat @ w_gates), (B, E), mixes the experts
    for every tower."""

    @staticmethod
    def _gates_shape(num_tasks: float, features: int, num_experts: int) -> tuple:
        return (features, num_experts)

    def gates(self, flat: torch.Tensor) -> list[torch.Tensor]:
        return [softmax(flat @ self.w_gates, dim=-1)] * len(self.tower_names)


class PLECut(nn.Module):
    """PLE-style expert-subset gating (reference PLECut.py:56-104): three
    experts with two heads each (dh = 128 at d_model 256, so the per-slice
    attention kernels), and three fixed towers, class / rerank / cut, whose
    gates `w_gate_t` mix the experts {0, 1}, {1, 2} and {0, 1, 2}. Returns
    the three heads as (B, L, 1) tensors; the last is the cut distribution.
    In training mode with dropout above 0, `forward` needs a
    `torch.Generator` on the input's device for the dropout masks. With
    `members=K`, K PLECuts in one, as MMOECut's. Under ep (three ranks of
    one expert each) a tower mixes the experts of its subset held here,
    none on some ranks, and sums over the model group."""

    part: Part | None = None  # under a parallel layout (`layers.Part`)

    # each tower's experts, as a slice of the expert axis
    SUBSETS = (slice(0, 2), slice(1, 3), slice(0, 3))
    TOWERS = (("tower_class", TowerClass), ("tower_rerank", TowerRerank),
              ("tower_cut", TowerCut))

    def __init__(self, seq_len: int = 300, input_size: int = 3,
                 encoding_size: int = 128, d_model: int = 256, n_head: int = 2,
                 num_layers: int = 1, dropout: float | Sequence[float] = 0.1, seed: int = 0,
                 members: int | None = None):
        super().__init__()
        if d_model != 2 * encoding_size:
            raise ValueError(f"d_model={d_model} must be twice the BiLSTM "
                             f"encoding_size={encoding_size}")
        g = torch.Generator().manual_seed(seed)
        self.pre_encoding = LSTM(input_size, encoding_size, 2, generator=g,
                                 members=members)
        self.experts = ExpertStack(3, d_model, n_head, num_layers, g, dropout, members)
        feat = encoding_size * seq_len * 2
        lead = () if members is None else (members,)
        for t, subset in enumerate(self.SUBSETS):
            w = torch.empty(lead + (feat, subset.stop - subset.start)).normal_(generator=g)
            self.register_parameter(f"w_gate_{t}", nn.Parameter(w))
        for name, cls in self.TOWERS:
            self.add_module(name, cls(d_model, g, members))

    def forward(self, x: torch.Tensor, generator=None) -> list[torch.Tensor]:
        experts_in = self.pre_encoding(x)  # (B, L, 2H)
        return self.heads(experts_in, self.experts(experts_in, generator))

    def heads(self, experts_in: torch.Tensor,
              experts_o: torch.Tensor) -> list[torch.Tensor]:
        """Gates and towers: BiLSTM output (B, L, 2H) and expert outputs
        (3, B, L, D) -> the three heads; with members (K, B, L, 2H) and (K,
        3, B, L, D) -> (K, B, L, 1) heads."""
        flat = experts_in.flatten(-2)  # (B, 2*H*L), or (K, B, 2*H*L)
        members = flat.dim() == 3
        outputs = []
        for t, (subset, (name, _)) in enumerate(zip(self.SUBSETS, self.TOWERS)):
            gate = softmax(flat @ getattr(self, f"w_gate_{t}"), dim=-1)
            if _ep(self.part):
                gate, held = local_gate(gate, self.part, subset.start, experts_o.shape[-4])
                outputs.append(getattr(self, name)(experts_o[held], gates=gate,
                                                   group=self.part.group))
                continue
            experts = experts_o[:, subset] if members else experts_o[subset]
            outputs.append(getattr(self, name)(experts, gates=gate))
        return outputs
