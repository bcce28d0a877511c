"""One CUDA graph per step: the port's counterpart of the JAX package's
jitted programs.

The JAX package runs its train steps inside one jitted program an epoch
block and serves each batch shape through one jitted `_predict`. Eager
PyTorch issues every op of a step from Python, and at the zoo's widths the
host's launches, not the card, set the pace of a step. `GraphedCall`
captures a callable once into a `torch.cuda.CUDAGraph` and then replays it:
the whole step is one launch.

- **Warm-up.** The callable first runs WARMUP times on a side stream, so
  that what may not happen inside a capture happens before it: the kernels'
  build and their launchers' static initialisations, cuBLAS's handles and
  workspaces, the optimizer's lazily made state.
- **Training state.** The warm-up's steps are real steps: they move the
  parameters, the optimizer's moments and step count, and the generators.
  `snapshot` saves these before the warm-up and restores them in place after
  it (the graph holds addresses, so none may move), and the first replay is
  the run's first step. A state the warm-up made (Adam's, at its first step)
  is zeroed, which is how Adam starts it.
- **Random bits.** Each generator the callable draws from is registered
  with the graph (`CUDAGraph.register_generator_state`): a replay draws at
  the generator's offset of the moment and moves it on by what the capture
  drew, so each replay draws fresh bits, the bits the eager step would draw.
- **Inputs and outputs.** The callable reads static buffers that its owner
  fills before each replay (the bf16 kernels encode each TMA map with a
  buffer's address at capture) and returns tensors that each replay
  overwrites.
- **Memory.** Graphs that never run at once may share one pool
  (`torch.cuda.graph_pool_handle()`): a Predictor's buckets, a Trainer's
  train and test steps (`GraphedSteps`, which a population shares). Their
  outputs stay referenced, so no later capture reuses them.
- **Launch counts.** `ops.build.Kernel.launches` rises in Python where a
  wrapper launches its kernel, which a replay does not pass through. The
  runner sets every count back after the capture to what it was before the
  warm-up (warm-up runs are no steps), and adds each kernel's captured
  launches at every replay.
- **Plain versions.** A replay runs the kernels baked in at capture whatever
  `ops.plain_ops()` routes the wrappers to, so both capture and replay
  raise inside it: a reference run through the plain versions runs eager.

A capture that fails raises; nothing falls back to eager. Graphs exist
only on a CUDA device: the CPU runs eager.
"""

from __future__ import annotations

import weakref
from typing import Callable, Iterable, Sequence

import torch

WARMUP = 2  # eager runs on a side stream before a capture


def use_graphs(device: torch.device, graphs: bool | None) -> bool:
    """Whether an owner on `device` runs its steps as CUDA graphs: `graphs`,
    by default on a CUDA device. Graphs on another device raise: the CPU
    runs eager."""
    if graphs is None:
        return device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs are captured on a CUDA device, not on {device}: "
                         "the CPU runs eager (graphs=False)")
    return graphs


def _kernel_counts() -> dict[str, int]:
    from rlt_tpu_torch.ops import KERNELS

    return {name: kernel.launches for name, kernel in KERNELS.items()}


def _refuse_plain(what: str) -> None:
    from rlt_tpu_torch.ops import plain_active

    if plain_active():
        raise RuntimeError(
            f"no CUDA graph {what} inside ops.plain_ops(): a graph replays the kernels "
            "it captured; run the plain reference eager (graphs=False)")


def snapshot(params: Iterable[torch.Tensor] = (), optimizer=None,
             generators: Sequence[torch.Generator] = ()) -> Callable[[], None]:
    """Save the parameters, the optimizer's state and the generators' states
    and return the function that restores them in place: the same tensors
    take back their values, and an optimizer state made after the save is
    zeroed (Adam's moments and step count start at 0). The optimizer is a
    `torch.optim.Optimizer` or any with its `.state` ({param: {name:
    tensor}}, as `population.MemberAdam`'s)."""
    params = list(params)
    saved = [p.detach().clone() for p in params]
    state = {} if optimizer is None else {
        p: {k: v.clone() for k, v in s.items() if torch.is_tensor(v)}
        for p, s in optimizer.state.items()}
    rng = [g.get_state() for g in generators]

    def restore() -> None:
        with torch.no_grad():
            for p, value in zip(params, saved):
                p.copy_(value)
            if optimizer is not None:
                for p, s in optimizer.state.items():
                    for k, v in s.items():
                        if not torch.is_tensor(v):
                            raise TypeError(f"optimizer state {k!r} is no tensor: "
                                            "a graph cannot hold it")
                        if k in state.get(p, {}):
                            v.copy_(state[p][k])
                        else:
                            v.zero_()
        for g, r in zip(generators, rng):
            g.set_state(r)

    return restore


class GraphedCall:
    """`fn` (no arguments; it reads static buffers) captured into one CUDA
    graph on the current device; calling the object replays it and returns
    the outputs of the capture, which every replay overwrites.

    `params`, `optimizer` and `generators` are the training state that `fn`
    moves: saved before the warm-up and restored after it. `generators` are
    also registered with the graph. `pool` is a memory pool shared with
    other graphs that never run at once. `capture_error_mode` is
    torch.cuda.graph's: "thread_local" where other threads may call CUDA
    while this one captures (a server's)."""

    def __init__(self, fn: Callable, *, pool=None, params: Iterable[torch.Tensor] = (),
                 optimizer=None, generators: Sequence[torch.Generator] = (),
                 capture_error_mode: str = "global"):
        from rlt_tpu_torch.ops import KERNELS

        _refuse_plain("capture")
        counts = _kernel_counts()
        restore = snapshot(params, optimizer, generators)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        restore()
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        start = _kernel_counts()
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode=capture_error_mode):
            self.outputs = fn()
        # each kernel's launches in one replay; the counts as before the warm-up
        self.launches = {name: n - start[name] for name, n in _kernel_counts().items()
                         if n != start[name]}
        for name, n in counts.items():
            KERNELS[name].launches = n

    def __call__(self):
        from rlt_tpu_torch.ops import KERNELS

        _refuse_plain("replay")
        self.graph.replay()
        for name, n in self.launches.items():
            KERNELS[name].launches += n
        return self.outputs


class GraphedSteps:
    """A trainer's train and test steps, each one `GraphedCall` captured at
    its first call and sharing one pool. `train(idx, valid)` and
    `test(idx, valid)` (None where the owner has no test step), the
    owner's bound methods, read a row of a batch plan; the graphs read it from static buffers of the plan row's shape,
    filled before each replay. The train step's capture saves and restores
    `params`, `optimizer` and `generators` and registers the generators
    with its graph. The methods are held weakly: the owner holds this
    object, and a reference back would keep the owner and its graphs' pool
    on the card until Python's cycle collector ran."""

    def __init__(self, train: Callable, test: Callable | None, shape: tuple, device, *,
                 params: Iterable[torch.Tensor], optimizer,
                 generators: Sequence[torch.Generator]):
        self.bodies = {"train": weakref.WeakMethod(train)}
        if test is not None:
            self.bodies["test"] = weakref.WeakMethod(test)
        self.state = dict(params=list(params), optimizer=optimizer,
                          generators=list(generators))
        self.idx = torch.zeros(shape, dtype=torch.int64, device=device)
        self.valid = torch.zeros(shape, device=device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: dict[str, GraphedCall] = {}

    def __call__(self, split: str, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """The step of `split` on plan row (idx, valid): a copy of the
        replay's output, which the next replay overwrites."""
        self.idx.copy_(idx)
        self.valid.copy_(valid)
        graph = self.graphs.get(split)
        if graph is None:
            body = self.bodies[split]()
            graph = self.graphs[split] = GraphedCall(
                lambda: body(self.idx, self.valid), pool=self.pool,
                **(self.state if split == "train" else {}))
        return graph().clone()
