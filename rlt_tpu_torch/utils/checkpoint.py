"""Training state on disk, for `--resume` (the JAX package's
`utils/checkpoint.py::save_train_state` / `load_train_state`).

One `torch.save` file, `<path>.trainstate.pt`, holds the f32 master
parameters (the model's state_dict), the optimizer's state by parameter
name (Adam's moments and its step count), the training generator's state
(seed and Philox offset: the batch plans and dropout masks go on where
they stopped) and the last finished epoch; `<path>.records.json` holds the
records (per-epoch test F1 and DCG and the bests), as the JAX package's
sidecar does.

A trainer's CUDA graphs read fixed parameter, optimizer-state and
generator objects (`utils/graphs.py`), so `restore_train_state` copies the
saved values into the tensors that are there and sets the generator's
state on the generator object itself; an optimizer state that does not
exist yet (no step taken) is made where Adam would make it. Restoring
before or after the graphs are captured gives the same run.

Under a parallel layout (`mesh`, a `parallel.ProcessMesh`) every rank calls
both: the save gathers each sharded parameter and its Adam moments whole
over the model group and rank 0 alone writes them, so that a state has no
layout and loads into a single process or any other layout; the restore
cuts the whole tensors to the rank's slices (`parallel.sharding`).
"""

from __future__ import annotations

import json
import os

import torch


def _state_path(path: str) -> str:
    return path + ".trainstate.pt"


def _whole(t: torch.Tensor, name: str, model, mesh) -> torch.Tensor:
    """t (a parameter's value or one of its moments) whole on the host."""
    dims = getattr(model, "shard_dims", {})
    if mesh is not None and t.dim() > 0:
        from rlt_tpu_torch.parallel.sharding import gather_tensor

        t = gather_tensor(t.detach(), dims.get(name), mesh)
    return t.detach().cpu().clone()


def save_train_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     generator: torch.Generator, epoch: int,
                     records: dict | None = None, mesh=None) -> str:
    """Write the training state after `epoch`; returns the state file's path
    (under a `mesh` every rank calls it, and rank 0 writes)."""
    names = {p: name for name, p in model.named_parameters()}
    payload = {
        "params": {k: _whole(v, k, model, mesh) for k, v in model.state_dict().items()},
        "optimizer": {names[p]: {k: _whole(v, names[p], model, mesh) for k, v in s.items()}
                      for p, s in optimizer.state.items() if s},
        "generator": generator.get_state(),
        "epoch": int(epoch),
    }
    out = _state_path(path)
    if mesh is None or mesh.is_writer:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        torch.save(payload, out + ".tmp")
        os.replace(out + ".tmp", out)  # a reader never sees half a file
        if records is not None:
            with open(path + ".records.json", "w") as f:
                json.dump(records, f)
    if mesh is not None:  # no rank reads the state before rank 0 wrote it
        mesh.barrier()
    return out


def load_train_state(path: str) -> dict | None:
    """The dict `save_train_state` wrote, with "records" from the sidecar
    when present, or None when there is no state file."""
    state = _state_path(path)
    if not os.path.isfile(state):
        return None
    payload = torch.load(state, map_location="cpu", weights_only=True)
    records = path + ".records.json"
    if os.path.exists(records):
        with open(records) as f:
            payload["records"] = json.load(f)
    return payload


def restore_train_state(payload: dict, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, generator: torch.Generator,
                        mesh=None) -> None:
    """Copy a saved state into the model's tensors, the optimizer's state
    and the generator, in place; under a `mesh` each rank takes its slices
    of the whole tensors."""
    if mesh is not None:
        from rlt_tpu_torch.parallel.sharding import local_state

        dims = getattr(model, "shard_dims", {})
        payload = dict(payload, params=local_state(payload["params"], dims, mesh),
                       optimizer={name: {k: local_state({name: v}, dims, mesh)[name]
                                         if v.dim() > 0 else v for k, v in s.items()}
                                  for name, s in payload["optimizer"].items()})
    params = model.state_dict()
    if set(payload["params"]) != set(params):
        raise ValueError(f"the saved parameters {sorted(payload['params'])} are not the "
                         f"model's {sorted(params)}")
    named = dict(model.named_parameters())
    # Adam keeps its step count on the parameter's device when capturable (or
    # fused), on the CPU otherwise
    on_device = any(g.get("capturable") or g.get("fused") for g in optimizer.param_groups)
    with torch.no_grad():
        for name, value in params.items():
            value.copy_(payload["params"][name])
        for name, saved in payload["optimizer"].items():
            p = named[name]
            state = optimizer.state[p]
            for key, value in saved.items():
                if key in state:
                    state[key].copy_(value)
                else:
                    device = p.device if key != "step" or on_device else "cpu"
                    state[key] = value.to(device, copy=True)
    generator.set_state(payload["generator"])
