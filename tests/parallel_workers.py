"""What the ranks of the parallel tests run (tests/test_torch_parallel*.py).

`rlt_tpu_torch.parallel.launch` spawns its processes with the `spawn`
start method, which imports the function it runs by its module: this
module imports torch, numpy and the port only, so that a rank does not
import JAX. Each function runs on every rank of one launch, on one torch
thread, and returns what the test compares (numpy arrays and CPU tensors).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.data import RankedListData, synthetic_dataset

SEQ_LEN, FEATURES, QUERIES, BATCH = 16, 3, 14, 7
STEPS = 3


def config(model_name: str = "mmoecut", **kw) -> TrainConfig:
    return TrainConfig(**{**dict(model_name=model_name, seq_len_override=SEQ_LEN,
                                 input_size_override=FEATURES, synthetic_queries=QUERIES,
                                 batch_size=BATCH, epochs=1, dropout=0.0), **kw})


def dataset(seed: int = 0) -> RankedListData:
    return synthetic_dataset(num_queries=QUERIES, seq_len=SEQ_LEN, num_features=FEATURES,
                             mean_relevant=4.0, seed=seed)


NO_RELEVANT_SEED = 5  # a model seed whose rerank hinge on that batch is above 0


def no_relevant_dataset() -> tuple[RankedListData, np.ndarray]:
    """The corpus with the labels of its train lists 0..2 set to 0, and a
    plan row whose last three rows are those lists: over two data ranks of
    four rows each, rank 1's rows hold no relevant label."""
    data = dataset()
    y = data.y_train.copy()
    y[:3] = 0.0
    idx = np.array([3, 4, 5, 6, 0, 1, 2])
    assert y[idx[:4]].sum() > 0
    return dataclasses.replace(data, y_train=y), idx


def mmoecut(num_experts: int, cfg: TrainConfig):
    from rlt_tpu_torch.models.mmoe import MMOECut

    return MMOECut(seq_len=SEQ_LEN, input_size=FEATURES, dropout=cfg.dropout,
                   num_experts=num_experts, seed=cfg.seed)


def steps(cfg: TrainConfig, mesh=None, data=None, rows=None, model=None, state_dict=None,
          n: int = STEPS, grads: bool = False, device: str = "cpu") -> dict:
    """n eager train steps of a Trainer on `device` (on `rows`, one plan row, or
    the first n rows of its first plan): the (n, 3) step results, the whole
    initial and final state_dicts, the collectives the steps issued, each
    parameter's local shape, and with `grads` the whole gradients of the
    last step."""
    from rlt_tpu_torch.parallel.functional import CALLS
    from rlt_tpu_torch.train import Trainer

    trainer = Trainer(cfg, data=dataset() if data is None else data, device=device,
                      mesh=mesh, model=model, state_dict=state_dict, graphs=False)
    init = {k: v.detach().cpu().clone() for k, v in trainer.whole_state_dict().items()}
    idx, valid = trainer.data.plan(trainer.generator, "train")
    if rows is not None:
        idx = torch.as_tensor(rows)[None].repeat(n, 1)
        valid = torch.ones(idx.shape)
    CALLS.clear()
    out = np.stack([trainer.train_batch(idx[s % len(idx)], valid[s % len(idx)]).cpu().numpy()
                    for s in range(n)])
    if grads:
        from rlt_tpu_torch.parallel.sharding import gather_tensor

        dims = getattr(trainer.model, "shard_dims", {})
        grads = {k: p.grad.clone() if mesh is None else gather_tensor(p.grad, dims[k], mesh)
                 for k, p in trainer.model.named_parameters()}
    host = lambda state: {k: v.detach().cpu().clone() for k, v in state.items()}  # noqa: E731
    if grads:
        grads = host(grads)
    return {"grads": grads or None,"steps": out, "init": init, "calls": dict(CALLS),
            "local": {k: tuple(p.shape) for k, p in trainer.model.named_parameters()},
            "final": {k: v.detach().cpu().clone()
                      for k, v in trainer.whole_state_dict().items()}}


def run_epochs(cfg: TrainConfig, mesh=None, resume: bool = False) -> dict:
    from rlt_tpu_torch.train import Trainer

    trainer = Trainer(cfg, data=dataset(), device="cpu", mesh=mesh)
    summary = trainer.run(resume=resume)
    return {"f1_record": list(trainer.f1_record), "summary": summary,
            "final": {k: v.clone() for k, v in trainer.whole_state_dict().items()}}


def resume_case(cfg: TrainConfig, mesh, workdir: str) -> dict:
    """`epochs` uninterrupted, against epochs - 1 then resumed for one more,
    both under the mesh; and the state the sharded run wrote."""
    epochs = cfg.epochs
    full = run_epochs(dataclasses.replace(cfg, model_persist=True,
                                          save_path=os.path.join(workdir, "full")), mesh)
    part = dataclasses.replace(cfg, model_persist=True,
                               save_path=os.path.join(workdir, "part"))
    run_epochs(dataclasses.replace(part, epochs=epochs - 1), mesh)
    resumed = run_epochs(part, mesh, resume=True)
    return {"full": full, "resumed": resumed}


def world2(workdir: str) -> dict:
    """Every case of a (2, 1) world."""
    from rlt_tpu_torch.parallel import data_parallel_mesh
    from rlt_tpu_torch.population import train_population

    mesh = data_parallel_mesh(2)
    data, rows = no_relevant_dataset()
    out = {
        "mmoecut": steps(config("mmoecut"), mesh),
        "attncut_wass": steps(config("attncut", loss_override="wass"), mesh),
        "no_relevant": steps(config("mmoecut", seed=NO_RELEVANT_SEED), mesh, data=data,
                             rows=rows),
        "bf16": steps(config("mmoecut", compute_dtype="bfloat16"), mesh),
        "dropout": steps(config("mmoecut", dropout=0.1), mesh),
        "resume": resume_case(config("attncut", epochs=3), mesh,
                              os.path.join(workdir, "resume")),
        "population": train_population(config("mmoecut", epochs=2, dropout=0.1),
                                       population_members(), mesh=mesh, device="cpu"),
    }
    try:
        train_population(config("mmoecut"), population_members()[:3], mesh=mesh,
                         device="cpu")
    except ValueError as e:
        out["odd_population"] = str(e)
    out["search_cli"] = search_cli(workdir)
    return out


def population_members():
    from rlt_tpu_torch.population import Member

    return [Member(seed=0), Member(seed=1, dropout=0.25), Member(seed=2),
            Member(seed=3, dropout=0.0)]


def world4(workdir: str) -> dict:
    """Every case of a world of four: dp (4, 1) and the (2, 2) layouts."""
    from rlt_tpu_torch.parallel import data_parallel_mesh, mesh_2d

    dp = data_parallel_mesh(4)
    grid = mesh_2d(4, 2)
    drop = config("mmoecut", dropout=0.1)
    return {
        "mmoecut": steps(config("mmoecut"), dp),
        "attncut_wass": steps(config("attncut", loss_override="wass"), dp),
        "dropout": steps(drop, dp),
        "tp": steps(drop, grid),
        "ep_dp": steps(drop, dp, model=mmoecut(4, drop)),
        "ep": steps(drop, grid, model=mmoecut(4, drop)),
        "attncut_dp": steps(config("attncut", dropout=0.1), dp),
        "attncut_tp": steps(config("attncut", dropout=0.1), grid),
        "mtple_dp": steps(config("mtple", dropout=0.1), dp),
        "mtple_tp": steps(config("mtple", dropout=0.1), grid),
        "resume_tp": resume_case(config("mmoecut", epochs=2, dropout=0.1), grid,
                                 os.path.join(workdir, "resume_tp")),
    }


def mesh_cases() -> dict:
    """The meshes a world of two builds and refuses, and `gather_rows`."""
    from rlt_tpu_torch.parallel import data_parallel_mesh, mesh_2d
    from rlt_tpu_torch.parallel.functional import gather_rows

    out = {}
    for name, build in (("mesh_2d_4", lambda: mesh_2d(4, 2)),
                        ("mesh_2d_3", lambda: mesh_2d(2, 3)),
                        ("dp_3", lambda: data_parallel_mesh(3))):
        try:
            build()
        except ValueError as e:
            out[name] = str(e)
    for name, mesh in (("dp", data_parallel_mesh()), ("grid", mesh_2d(2, 2)),
                       ("dp_1", data_parallel_mesh(1))):
        out[name] = {"shape": mesh.shape, "member": mesh.member, "rank": mesh.rank,
                     "data": mesh.data and mesh.data.ranks,
                     "model": mesh.model and mesh.model.ranks}
    mesh = data_parallel_mesh()
    x = torch.arange(8, dtype=torch.float32).view(4, 2).add(10 * mesh.rank).requires_grad_()
    y = gather_rows(x, mesh.data, 7)
    weights = torch.arange(14, dtype=torch.float32).view(7, 2)
    (y * weights).sum().backward()
    out["gather"] = {"y": y.detach(), "grad": x.grad}
    return out


def raises_on_rank_1() -> None:
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ArithmeticError("rank 1 failed")


JAX_BATCH = 8  # the JAX package's sharded batch divides over its 4 devices
JAX_LAYOUTS = {"dp": (1, 3), "tp": (2, 3), "ep": (2, 4)}  # model_parallel, E


def jax_layouts(state_dicts: dict) -> dict:
    """One step of each layout on a world of four from the JAX package's
    initial weights (`state_dicts` by E), on the train lists 0..7, at rate
    0."""
    from rlt_tpu_torch.parallel import mesh_2d

    cfg = config("mmoecut", batch_size=JAX_BATCH)
    return {name: steps(cfg, mesh_2d(4, m), model=mmoecut(e, cfg), state_dict=state_dicts[e],
                        rows=np.arange(JAX_BATCH), n=1, grads=True)
            for name, (m, e) in JAX_LAYOUTS.items()}


def search_cli(workdir: str) -> dict:
    """The train CLI's member-sharded population search on this launch:
    three trials at a population of 2 (a chunk of two, one member a rank,
    and one of one on rank 0)."""
    from rlt_tpu_torch import train

    record = os.path.join(workdir, "record.log")
    return train.main(["--device", "cpu", "--retrieve-data", "mq2007",
                       "--synthetic-queries", "12", "--batch-size", "5", "--epochs", "1",
                       "--parameter-search", "1", "--regularizer-search", "1",
                       "--population", "2", "--search-times", "3", "--data-parallel", "1",
                       "--parameter-record", record])


def card_ranks() -> dict:
    """Two ranks sharing one card over gloo (NCCL takes no two ranks on one
    card), eager at the small width: dp 2 x 1, and tp 1 x 2 (E = 3) and ep
    1 x 2 (E = 4) with dropout on against dp 2 x 1; then a population of
    four, two members a rank, graphed."""
    from rlt_tpu_torch.parallel import data_parallel_mesh, mesh_2d
    from rlt_tpu_torch.population import train_population

    dp, grid = data_parallel_mesh(2), mesh_2d(2, 2)
    drop = config("mmoecut", dropout=0.1)
    out = {"dp": steps(config("mmoecut"), dp, device="cuda"),
           "dropout": steps(drop, dp, device="cuda"),
           "tp": steps(drop, grid, device="cuda"),
           "ep_dp": steps(drop, dp, model=mmoecut(4, drop), device="cuda"),
           "ep": steps(drop, grid, model=mmoecut(4, drop), device="cuda")}
    pop = train_population(config("mmoecut", epochs=2, dropout=0.1), population_members(),
                           mesh=dp, device="cuda", track_best_params=True)
    out["population"] = pop
    return out


def plecut_ep() -> dict:
    """PLECut (three experts) over three ranks: ep 1 x 3, one expert a rank
    (a tower whose subset misses a rank's expert mixes none there), and dp 3
    x 1, dropout on."""
    from rlt_tpu_torch.parallel import data_parallel_mesh, mesh_2d

    cfg = config("mtple", dropout=0.1)
    return {"ep": steps(cfg, mesh_2d(3, 3)), "dp": steps(cfg, data_parallel_mesh(3))}
