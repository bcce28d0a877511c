"""Expert- and tensor-parallel layouts of the port's models (the JAX
package's `parallel/sharding.py`).

The rules are the JAX package's `_spec_for`, read from the port's
state_dict names (which are the flax paths, joined by dots): on a model
axis of m ranks,

- **ep**: every parameter under `experts` whose leading (expert) axis E
  divides by m is split on that axis, each rank holding E / m whole
  experts;
- **tp** (the fallback): `linear1.weight` is split by its output rows,
  `linear1.bias` alike, and `linear2.weight` by its input columns
  (Megatron's split of the encoder FFN);
- everything else is replicated, and so is every parameter at m = 1.

`param_shardings` gives each name its split dimension or None.
`shard_module` keeps a rank's slice of each split parameter and sets each
layer's `layers.Part` (its rows of the batch, and its experts or FFN
columns with the model group), which makes the layers issue the model
group's collectives (`parallel/functional.py`) and draw their dropout bits
whole. `gather_state_dict` puts the whole tensors back together, and
`local_state` cuts whole tensors to a rank's slices.
"""

from __future__ import annotations

import torch

from rlt_tpu_torch.parallel.functional import all_gather
from rlt_tpu_torch.parallel.mesh import ProcessMesh, padded_batch


def spec_for(name: str, shape: tuple, model_size: int) -> int | None:
    """The dimension `name` (of `shape`) is split on over a model axis of
    `model_size` ranks, or None (replicated)."""
    parts = name.split(".")
    if model_size <= 1:
        return None
    if "experts" in parts and len(shape) >= 1 and shape[0] % model_size == 0:
        return 0
    if len(parts) >= 2:
        layer, param = parts[-2], parts[-1]
        if layer == "linear1" and param == "weight" and shape[-2] % model_size == 0:
            return len(shape) - 2
        if layer == "linear1" and param == "bias" and shape[-1] % model_size == 0:
            return len(shape) - 1
        if layer == "linear2" and param == "weight" and shape[-1] % model_size == 0:
            return len(shape) - 1
    return None


def param_shardings(state: dict, model_size: int) -> dict[str, int | None]:
    """Each name of a (whole) state_dict: its split dimension or None."""
    return {name: spec_for(name, tuple(t.shape), model_size) for name, t in state.items()}


def _slice(t: torch.Tensor, dim: int | None, rank: int, size: int) -> torch.Tensor:
    if dim is None:
        return t
    return t.chunk(size, dim=dim)[rank]


def local_state(state: dict, dims: dict, mesh: ProcessMesh) -> dict:
    """A whole state_dict (or any dict of whole tensors by parameter name)
    cut to this rank's slices."""
    return {name: _slice(t, dims.get(name), mesh.model_rank, mesh.model_size).contiguous()
            for name, t in state.items()}


def shard_module(model: torch.nn.Module, mesh: ProcessMesh, batch: int) -> dict:
    """Lay `model` (whole, on its device) out over `mesh` in place, for
    batches of `batch` rows: each split parameter keeps this rank's slice,
    and each layer with a `part` gets its `layers.Part`. Returns the
    split dimensions by name (`param_shardings`), also kept as
    `model.shard_dims`."""
    from rlt_tpu_torch.models.layers import Part, TransformerEncoderLayer

    m = mesh.model_size
    params = dict(model.named_parameters())
    dims = param_shardings(params, m)
    rows = padded_batch(batch, mesh.data_size) // mesh.data_size
    # ep: the expert stack's leading axis E, split whole experts a rank
    stack = [p.shape[0] for n, p in params.items()
             if n.split(".")[0] == "experts" and dims[n] == 0]
    experts = (stack[0], mesh.model_rank * stack[0] // m) if stack else None
    for prefix, module in model.named_modules():
        if not hasattr(module, "part"):
            continue
        in_stack = prefix == "" or prefix.split(".")[0] == "experts"
        columns = None
        if isinstance(module, TransformerEncoderLayer):
            dim = dims[prefix + ".linear1.weight"]
            if dim is not None and not (experts and in_stack):
                f = module.linear1.weight.shape[-2]
                columns = (f, mesh.model_rank * f // m)
        module.part = Part(rows=(batch, mesh.data_rank * rows),
                           experts=experts if in_stack else None, columns=columns,
                           group=mesh.model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if dims[name] is not None:
                p.data = _slice(p.data, dims[name], mesh.model_rank, m).contiguous()
    model.shard_dims = dims
    return dims


def gather_tensor(t: torch.Tensor, dim: int | None, mesh: ProcessMesh) -> torch.Tensor:
    """The whole tensor of this rank's slice t (split on `dim`)."""
    if dim is None:
        return t
    whole = all_gather(t.movedim(dim, 0), mesh.model)  # ranks' slices, stacked on dim 0
    return whole.movedim(0, dim).contiguous()


def gather_state_dict(model: torch.nn.Module, mesh: ProcessMesh,
                      state: dict | None = None) -> dict:
    """The model's whole state_dict (or `state`, a snapshot of it), on
    every rank of the model group (a collective of the model group: every
    rank calls it)."""
    dims = getattr(model, "shard_dims", {})
    state = model.state_dict() if state is None else state
    return {name: gather_tensor(t.detach(), dims.get(name), mesh)
            for name, t in state.items()}
