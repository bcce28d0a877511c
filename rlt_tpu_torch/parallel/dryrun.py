"""The multi-process dry run (the JAX package's
`__graft_entry__.py::dryrun_multichip`).

    python -c "from rlt_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"

Full training steps of the four layouts the port ships, on tiny shapes (L =
32, three features, two lists a rank), over n processes: NCCL when n cards
are visible, else n gloo processes on the CPU (torch needs a process a rank
where JAX makes n virtual CPU devices in one process).

1. data parallel: the batch over n ranks, the parameters replicated, the
   gradients summed;
2. data x tensor parallel: MMOECut at E = 3, which a model axis of 2 cannot
   split, so its encoder FFN is Megatron-split;
3. data x expert parallel: MMOECut at E = 4, whole experts over the model
   axis;
4. a population of 2n members sharded over the n ranks, two whole members
   a rank, whose member 0 reproduces its own unsharded run.

Each asserts the launch has exactly n ranks, so that no smaller world can
pass for n.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

SEQ_LEN, FEATURES = 32, 3


def _config(n: int, **kw):
    from rlt_tpu_torch.config import TrainConfig

    return TrainConfig(**{**dict(model_name="mmoecut", seq_len_override=SEQ_LEN,
                                 input_size_override=FEATURES, synthetic_queries=4 * n,
                                 batch_size=2 * n, epochs=1, dropout=0.1), **kw})


def _data(queries: int):
    from rlt_tpu_torch.data import synthetic_dataset

    return synthetic_dataset(num_queries=queries, seq_len=SEQ_LEN, num_features=FEATURES,
                             mean_relevant=6.0, seed=0)


def dryrun_step(n: int, device: str, model_parallel: int = 1, num_experts: int = 3):
    """One train step of MMOECut at `num_experts` experts on an (n /
    model_parallel, model_parallel) mesh of the running launch: the loss,
    and the trainer."""
    from rlt_tpu_torch.models.mmoe import MMOECut
    from rlt_tpu_torch.parallel import mesh_2d
    from rlt_tpu_torch.train import Trainer

    mesh = mesh_2d(n, model_parallel)
    assert mesh.size == n, f"mesh has {mesh.size} ranks, the dry run requires {n}"
    cfg = _config(n)
    model = MMOECut(seq_len=SEQ_LEN, input_size=FEATURES, dropout=cfg.dropout,
                    num_experts=num_experts)
    trainer = Trainer(cfg, data=_data(cfg.synthetic_queries), device=device, mesh=mesh,
                      model=model)
    idx, valid = trainer.data.plan(trainer.generator, "train")
    loss = float(trainer.train_batch(idx[0], valid[0])[0])
    assert math.isfinite(loss), f"non-finite loss in the dry run: {loss}"
    return loss, trainer


def _dryrun_population(n: int, device: str) -> None:
    from rlt_tpu_torch.parallel import data_parallel_mesh
    from rlt_tpu_torch.population import Member, train_population

    mesh = data_parallel_mesh(n)
    cfg = _config(n, synthetic_queries=16, batch_size=8, epochs=2)
    data = _data(16)
    members = [Member(seed=i % 4, dropout=0.05 + 0.01 * (i % 3)) for i in range(2 * n)]
    out = train_population(cfg, members, data=data, mesh=mesh, device=device)
    for row in out["per_member"]:
        assert np.isfinite(row["best_f1"]), f"non-finite member: {row}"
    if mesh.rank == 0:
        solo = train_population(cfg, members[:1], data=data, device=device)
        np.testing.assert_allclose(out["f1_record"][0], solo["f1_record"][0], atol=1e-6)


def _dryrun_rank(n: int, device: str) -> dict:
    world = dist.get_world_size()
    assert world == n, f"the launch has {world} ranks, the dry run requires {n}"
    mp = 2 if n % 2 == 0 else 1
    losses = {"dp": dryrun_step(n, device)[0]}
    _, tp = dryrun_step(n, device, model_parallel=mp)
    _, ep = dryrun_step(n, device, model_parallel=mp, num_experts=2 * mp)
    if mp > 1:  # the layouts are the ones asked for
        name = "experts.attention_layer.layers_0.linear1.weight"
        assert tp.model.shard_dims[name] == 1 and ep.model.shard_dims[name] == 0
    _dryrun_population(n, device)
    return {"world": world, **losses}


def dryrun_multichip(n_devices: int) -> list[dict]:
    """The four layouts over n_devices processes (NCCL on n visible cards,
    else gloo on the CPU); each rank's summary."""
    from rlt_tpu_torch.parallel import launch

    cuda = torch.cuda.is_available() and torch.cuda.device_count() >= n_devices
    device = "cuda" if cuda else "cpu"
    out = launch(_dryrun_rank, n_devices, n_devices, device,
                 backend="nccl" if cuda else "gloo", env={"OMP_NUM_THREADS": "1"})
    assert len(out) == n_devices and all(r["world"] == n_devices for r in out)
    return out


if __name__ == "__main__":
    import sys

    print(dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2))
