"""The process mesh of the parallel layouts (the JAX package's
`parallel/mesh.py` and `mesh_2d` of `parallel/sharding.py`).

The JAX package is one process that drives every device of a
`jax.sharding.Mesh`. torch runs one process per card, so the port needs
what JAX does not: a launch and a process group. `ProcessMesh` is the
counterpart of the mesh: the world, this process's rank, a data group and a
model group over a (data, model) grid of ranks (rank = i * model + j, as the
JAX package reshapes its devices). Its groups run over NCCL on the card and
gloo on the CPU; a failed `init_process_group` raises, and nothing falls
back to one process.

- **Launch.** Under `torchrun` (RANK, WORLD_SIZE and LOCAL_RANK set) a
  process joins that launch (`init_process_group_from_env`). On the card
  with one visible card and no launcher, the process is a world of one
  (`init_single`). `launch` spawns one process per rank with the `spawn`
  start method (the train CLI, one per visible card; the tests and
  `dryrun.py`, gloo processes on the CPU).
- **Sizes.** `data_parallel_mesh(n)` and `mesh_2d(n, model_parallel)` take
  the JAX functions' arguments and refuse what they refuse: more ranks than
  the launch has (no silent downscale) and a model_parallel that does not
  divide. Ranks past n take part in no layout (`ProcessMesh.member`).
- **Data.** Every rank holds the whole dataset on its device (a few MB; the
  JAX package shards the dataset's rows instead). Each data rank takes its
  contiguous rows of each batch plan row (`local_rows`), the row padded with
  invalid rows to a multiple of the data size, as the JAX package pads rows
  to a multiple of the device count.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Group:
    """One axis's group as a rank sees it: its name ("data" or "model"),
    its ranks, its ProcessGroup, this rank's index in it and its backend."""

    name: str
    ranks: tuple
    handle: Any
    rank: int
    backend: str

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """A (data, model) grid over the first data * model ranks of the launch:
    this rank's place in it and its two groups. `member` is False on a rank
    past the grid, which holds no group of it."""

    data_size: int
    model_size: int
    rank: int
    data: Group | None
    model: Group | None
    everyone: Group | None = None  # all the mesh's ranks

    @property
    def size(self) -> int:
        return self.data_size * self.model_size

    @property
    def shape(self) -> dict:
        return {"data": self.data_size, "model": self.model_size}

    @property
    def member(self) -> bool:
        return self.data is not None

    @property
    def data_rank(self) -> int:
        return self.data.rank

    @property
    def model_rank(self) -> int:
        return self.model.rank

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes the run's files: the mesh's rank 0."""
        return self.rank == 0

    def barrier(self) -> None:
        """Wait for every rank of the mesh (after rank 0 wrote a file that
        the others read)."""
        dist.barrier(group=self.everyone.handle)


def backend_for(device: torch.device | str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group_from_env(device: torch.device | str) -> None:
    """Join a `torchrun` launch (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT;
    LOCAL_RANK picks the card)."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    dist.init_process_group(backend_for(device), init_method="env://")


def init_single(device: torch.device | str) -> None:
    """A world of one process over a file store of its own."""
    store = os.path.join(tempfile.mkdtemp(prefix="rlt_dist_"), "store")
    dist.init_process_group(backend_for(device), init_method=f"file://{store}", rank=0,
                            world_size=1)


def launched() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def ensure_process_group(device: torch.device | str) -> None:
    """The process group of this process: the one there is; a `torchrun`
    launch's; on the card with one visible card, a world of one. Anything
    else raises: N cards take N processes, and the CPU runs parallel only
    under a launcher, never silently as one process."""
    if dist.is_initialized():
        return
    if launched():
        init_process_group_from_env(device)
        return
    if torch.device(device).type == "cuda" and torch.cuda.device_count() == 1:
        init_single(device)
        return
    where = ("the CPU" if torch.device(device).type != "cuda"
             else f"{torch.cuda.device_count()} cards")
    raise RuntimeError(
        f"data parallelism on {where} needs one process per rank: run under torchrun, "
        "or through the train CLI (which spawns one process per visible card), or "
        "rlt_tpu_torch.parallel.launch")


def _groups(rows: list[list[int]], name: str, rank: int, backend: str) -> Group | None:
    """new_group for each list of ranks, in the same order on every rank of
    the launch (as torch.distributed requires); this rank's Group."""
    world = dist.get_world_size()
    mine = None
    for ranks in rows:
        handle = (dist.group.WORLD if len(ranks) == world
                  else dist.new_group(ranks=ranks))
        if rank in ranks:
            mine = Group(name, tuple(ranks), handle, ranks.index(rank), backend)
    return mine


def mesh_2d(n: int | None = None, model_parallel: int = 1) -> ProcessMesh:
    """A (data, model) mesh of exactly n ranks of the running launch (all of
    them by default); n must divide by model_parallel, and a launch of fewer
    than n ranks is an error, never a smaller mesh."""
    if not dist.is_initialized():
        raise RuntimeError("mesh_2d: no process group; see ensure_process_group")
    world = dist.get_world_size()
    n = world if n is None else n
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"mesh_2d: model_parallel={model_parallel} must divide "
                         f"n_devices={n}")
    if n > world:
        raise ValueError(f"mesh_2d: need {n} devices, the launch has {world} processes "
                         f"({dist.get_backend()})")
    rank, backend = dist.get_rank(), dist.get_backend()
    d, m = n // model_parallel, model_parallel
    data = _groups([[i * m + j for i in range(d)] for j in range(m)], "data", rank, backend)
    model = _groups([[i * m + j for j in range(m)] for i in range(d)], "model", rank, backend)
    everyone = _groups([list(range(n))], "mesh", rank, backend)
    return ProcessMesh(d, m, rank, data, model, everyone)


def data_parallel_mesh(n: int | None = None) -> ProcessMesh:
    """A 1-D mesh over the batch axis: `mesh_2d(n, 1)`. Exactly n ranks are
    required: too few is an error, never a silent downscale."""
    return mesh_2d(n, 1)


def padded_batch(batch: int, data_size: int) -> int:
    """The batch padded to a multiple of the data size."""
    return -(-batch // data_size) * data_size


def local_rows(t: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """This data rank's contiguous rows of a plan row t (B, ...), the row
    padded with zeros to a multiple of the data size first (an index 0 or
    an invalid row: the padding is dropped by `gather_rows`)."""
    batch = t.shape[0]
    rows = padded_batch(batch, mesh.data_size) // mesh.data_size
    if rows * mesh.data_size > batch:
        t = torch.cat([t, t.new_zeros((rows * mesh.data_size - batch, *t.shape[1:]))])
    return t[mesh.data_rank * rows:(mesh.data_rank + 1) * rows]


def _spawned(rank: int, world: int, store: str, backend: str, fn: Callable, args: tuple,
             out_dir: str, env: dict) -> None:
    os.environ.update(env)
    if "OMP_NUM_THREADS" in env:  # torch read it at import, before this
        torch.set_num_threads(int(env["OMP_NUM_THREADS"]))
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, *args, backend: str = "gloo",
           env: dict | None = None) -> list:
    """fn(*args) in `world` spawned processes of one process group (`spawn`
    start method, a file store in a temporary directory); each rank's
    return value (torch.save-able), in rank order. A rank that raises makes
    this raise with its traceback. NCCL takes one card a rank; ranks that
    share a card take gloo. `env` is set in each process before fn runs."""
    import torch.multiprocessing as mp

    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one card a rank: {world} ranks, "
                         f"{torch.cuda.device_count()} cards")
    with tempfile.TemporaryDirectory(prefix="rlt_launch_") as tmp:
        mp.start_processes(_spawned, args=(world, os.path.join(tmp, "store"), backend, fn,
                                           args, tmp, dict(env or {})),
                           nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False)
                for r in range(world)]
