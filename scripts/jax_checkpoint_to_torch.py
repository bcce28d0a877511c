"""Convert a checkpoint of the JAX package's trainer into a torch state_dict
that the port's `--model-path` reads (`rlt_tpu_torch.infer`, `serve`,
`train`, `export`).

It runs where JAX is installed, which the CUDA machine need not be: it
imports both packages, so it lives outside `rlt_tpu_torch/`, which never
imports JAX. The checkpoint is read with the JAX package's own
`rlt_tpu.utils.checkpoint.load_params` (the `.orbax` directory or the
`.msgpack` file that `save_params` wrote under the base path), with the
model's init as the structure to restore into; the tree is converted by
`rlt_tpu_torch.utils.convert.params_from_jax`, loaded into the port's model
with `strict=True` (every leaf present, no leaf left over, every shape
equal), and written with `torch.save(model.state_dict())`.

    PYTHONPATH=. python scripts/jax_checkpoint_to_torch.py \\
        --model-name attncut --model-path best_model/attncut --out attncut.pt
"""

from __future__ import annotations

import argparse
import json


def convert(model_name: str, model_path: str, out: str, retrieve_data: str = "robust04",
            seq_len: int | None = None, input_size: int | None = None,
            num_tasks: float = 3.0) -> dict:
    """Read the JAX checkpoint at base path `model_path`, write the port's
    state_dict to `out`, and return a summary."""
    import jax
    import numpy as np
    import torch

    from rlt_tpu.config import TrainConfig as JaxTrainConfig
    from rlt_tpu.models import build_model as jax_build_model
    from rlt_tpu.utils.checkpoint import load_params
    from rlt_tpu_torch.models import build_model
    from rlt_tpu_torch.utils.convert import params_from_jax

    cfg = JaxTrainConfig(model_name=model_name, retrieve_data=retrieve_data,
                         seq_len_override=seq_len, input_size_override=input_size,
                         num_tasks=num_tasks)
    jax_model = jax_build_model(model_name, seq_len=cfg.seq_len, input_size=cfg.input_size,
                                dropout=cfg.dropout, num_tasks=cfg.num_tasks)
    key = jax.random.PRNGKey(0)
    sample = jax.numpy.zeros((1, cfg.seq_len, cfg.input_size), jax.numpy.float32)
    like = jax_model.init({"params": key, "dropout": key}, sample)["params"]
    params = load_params(model_path, like=like)
    if params is None:
        raise FileNotFoundError(f"--model-path {model_path!r}: no .orbax or .msgpack "
                                "checkpoint of save_params there")
    state = params_from_jax(jax.tree.map(np.asarray, params))
    model = build_model(model_name, seq_len=cfg.seq_len, input_size=cfg.input_size,
                        dropout=cfg.dropout, num_tasks=cfg.num_tasks)
    model.load_state_dict(state, strict=True)
    torch.save(model.state_dict(), out)
    return {"model_name": model_name, "out": out, "seq_len": cfg.seq_len,
            "input_size": cfg.input_size, "leaves": len(state),
            "parameters": int(sum(t.numel() for t in state.values()))}


def main(argv=None):
    p = argparse.ArgumentParser(description="JAX checkpoint -> torch state_dict")
    p.add_argument("--model-name", type=str, required=True)
    p.add_argument("--model-path", type=str, required=True,
                   help="the base path given to rlt_tpu's save_params (its "
                   ".orbax or .msgpack beside it)")
    p.add_argument("--out", type=str, required=True, help="the state_dict file to write")
    p.add_argument("--retrieve-data", type=str, default="robust04",
                   help="shape preset: robust04 (L=300) | mq2007 (L=40)")
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--input-size", type=int, default=None)
    p.add_argument("--num-tasks", type=float, default=3.0)
    args = p.parse_args(argv)
    print(json.dumps(convert(args.model_name, args.model_path, args.out, args.retrieve_data,
                             args.seq_len, args.input_size, args.num_tasks)))


if __name__ == "__main__":
    main()
