"""Serving export: trace once, serve from a saved artifact.

The counterpart of the JAX package's `export.py`. A Predictor's whole
forward (`infer.ForwardBody`: features -> cuts and distributions, the
casts and the decode included, BiCut's decision pairs too) is exported with
`torch.export` at one static batch size per bucket, its weights held in
the program, and written with `torch.export.save`. A serving host loads the
bundle and runs it without the model code, the checkpoint or a retrace.

A bundle is a directory:

    manifest.json   model, shapes, dtype, device, the buckets, the custom ops
    b<B>.pt2        one `torch.export.ExportedProgram` per batch size

The kernels enter a program as the custom ops of `ops/library.py`
(`rlt::lstm_fwd`, `rlt::attention_packed_fwd`, ...), registered when this
module imports `ops.library`, before any load; the manifest lists the ops its programs call
(`custom_ops`, where the JAX manifest says whether it waived the custom-call
check). The model builds tensors on its input's device, so a program is
exported for one device (`cuda` or `cpu`, `manifest["device"]`) and runs
only there: `load_exported` refuses a bundle made for another device, as
the JAX version refuses another platform.

A bundle for the card is exported on the card, or lowered on a host with
no card when the caller asks (`--device cuda --lower`, `save_exported(...,
device="cuda")` from a Predictor on the CPU), as the JAX CLI's
`--platforms tpu` builds a TPU artifact on a CPU host: the Predictor
is built on the CPU, its forward exported there, and that program's graph
(ATen ops and the `rlt::` ops, no Python of the model) traced again for
the card under fake tensors that claim the card and hold no data, its
device arguments set to the card (`lower_for_card`). Nothing of that
touches the CUDA runtime or builds a kernel: the `rlt::` ops run their fake
implementations. The program keeps the real weights, on the CPU, and
`load_exported` places every weight of a program on the device it serves
on, so such a bundle loads and serves on the card as one exported there.

`ExportedPredictor` has `infer.Predictor`'s serving surface (`predict`,
`predict_with_distribution`, `prepare`), pads a batch to the smallest
exported bucket that holds it, and on the card runs each bucket's program
as one CUDA graph (`utils/graphs.py::GraphedBuckets`, captured at its
first use), the counterpart of the JAX version's `jax.jit(e.call)`; the CPU runs
it eager. `rlt_tpu_torch.serve.TruncationService` serves straight from it
(`python -m rlt_tpu_torch.serve --exported <dir>`).

CLI:
    python -m rlt_tpu_torch.export --model-name mmoecut --model-path ck.pt \\
        --out bundles/mmoecut --batch-sizes 1,8,64,256 [--device cpu] [--check]

`--device cuda --lower` lowers the bundle for the card on the CPU, with or
without a card on the host; `--check` serves a bundle against the live
Predictor on its device and does not go with `--lower`. Without `--lower`,
`--device cuda` builds the Predictor on the card and fails on a host with
none.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch.utils._pytree import tree_map

from rlt_tpu_torch.ops import library
from rlt_tpu_torch.utils.graphs import GraphedBuckets, use_graphs
from rlt_tpu_torch.utils.platform import resolve_device

MANIFEST = "manifest.json"
FORMAT_VERSION = 1


def _bucket_path(bundle_dir: str, batch: int) -> str:
    return os.path.join(bundle_dir, f"b{batch}.pt2")


def _custom_ops(program) -> list[str]:
    """The `rlt::` ops a program calls, as `rlt::name`."""
    ops = set()
    for node in program.graph.nodes:
        target = node.target
        namespace = getattr(target, "namespace", None)
        if node.op == "call_function" and namespace == library.NAMESPACE:
            ops.add(f"{namespace}::{target._opname}")
    return sorted(ops)


# the card a program lowered on a host with no card names: the first, as
# a program traced on the card names its input's device
CARD = torch.device("cuda", 0)


def export_bucket(predictor, batch: int, device: str | torch.device | None = None):
    """`predictor`'s forward (`infer.Predictor.body`) exported at one static
    batch size, under `torch.no_grad()`, for `device`: the predictor's own
    (the default), or the card from a predictor on the CPU
    (`lower_for_card`)."""
    cfg = predictor.cfg
    device = predictor.device if device is None else torch.device(device)
    x = torch.zeros(batch, cfg.seq_len, cfg.input_size, device=predictor.device)
    with torch.no_grad():
        program = torch.export.export(predictor.body, (x,), strict=False)
    if device.type == predictor.device.type:
        return program
    if (predictor.device.type, device.type) != ("cpu", "cuda"):
        raise ValueError(f"a predictor on {predictor.device.type!r} exports for its own "
                         f"device, or for 'cuda' from the CPU, not for {device.type!r}")
    return lower_for_card(program, x)


def _card_device(arg):
    return CARD if isinstance(arg, torch.device) and arg.type == "cpu" else arg


def lower_for_card(program, x: torch.Tensor):
    """A program exported on the CPU from input `x`, traced again for the
    card: its graph module, with every device argument of its nodes set to
    the card and every weight a fake tensor that claims the card and holds
    no data, exported under that fake mode; then the real weights put back
    in the program's state, on the CPU. Only ATen ops and the `rlt::` ops'
    fake implementations run: nothing queries the CUDA runtime or builds a
    kernel, so a host with no card lowers it. (A fake CUDA tensor cannot
    run the model's own Python on a CPU-only torch: `__getitem__` and
    `.contiguous()` need a CUDA device guard it lacks.)"""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    module = program.module()
    for node in module.graph.nodes:
        node.args = tree_map(_card_device, node.args)
        node.kwargs = tree_map(_card_device, node.kwargs)
    module.recompile()
    mode = FakeTensorMode()

    def fake(t: torch.Tensor) -> torch.Tensor:
        return FakeTensor(mode, t.detach().to("meta"), CARD)

    real = {}  # each weight by its path, as the lowered program names it
    for node in module.graph.nodes:
        if node.op != "get_attr":
            continue
        *path, name = node.target.split(".")
        owner = module.get_submodule(".".join(path))
        value = getattr(owner, name)
        if not isinstance(value, torch.Tensor) or node.target in real:
            continue
        real[node.target] = value
        if isinstance(value, torch.nn.Parameter):
            owner._parameters[name] = torch.nn.Parameter(fake(value), requires_grad=False)
        elif name in owner._buffers:
            owner._buffers[name] = fake(value)
        else:
            setattr(owner, name, fake(value))
    with torch.no_grad():
        lowered = torch.export.export(module, (fake(x),), strict=False)
    for state in (lowered.state_dict, lowered.constants):
        for key, value in state.items():
            if isinstance(value, torch.Tensor):
                state[key] = real[key]
    lowered.example_inputs = None  # fake: nothing to save
    return lowered


def save_exported(out_dir: str, predictor, batch_sizes=(1, 8, 64, 256),
                  device: str | torch.device | None = None) -> dict:
    """Export `predictor` (`rlt_tpu_torch.infer.Predictor`) at each batch
    size for `device` (the predictor's own by default; "cuda" from a
    predictor on the CPU lowers the bundle for the card, `lower_for_card`)
    and write the bundle to `out_dir`. Returns the manifest."""
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
    os.makedirs(out_dir, exist_ok=True)
    cfg = predictor.cfg
    device = predictor.device if device is None else torch.device(device)
    custom_ops: set[str] = set()
    for b in batch_sizes:
        program = export_bucket(predictor, b, device)
        custom_ops.update(_custom_ops(program))
        torch.export.save(program, _bucket_path(out_dir, b))
    manifest = {
        "format_version": FORMAT_VERSION,
        "model_name": cfg.model_name,
        "seq_len": cfg.seq_len,
        "input_size": cfg.input_size,
        "compute_dtype": cfg.compute_dtype,
        "batch_sizes": batch_sizes,
        "device": device.type,
        "custom_ops": sorted(custom_ops),
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ExportedPredictor:
    """Serving view of a bundle: `infer.Predictor`'s predict surface over
    the loaded programs, no model code, checkpoint or retrace involved. On
    the card each bucket is one CUDA graph, captured at its first use into a
    static (B, L, F) input; the CPU runs eager. One forward at a time (the
    server's device lock)."""

    def __init__(self, manifest: dict, programs: dict, device: torch.device):
        self.manifest = manifest
        self.device = device
        self._modules = {b: programs[b].module() for b in sorted(programs)}
        self.graphs = use_graphs(device, None)
        # each bucket's graph, captured at first use
        self._buckets = (GraphedBuckets((self.seq_len, self.input_size), device,
                                        self._modules.__getitem__)
                         if self.graphs else None)

    @property
    def model_name(self) -> str:
        return self.manifest["model_name"]

    @property
    def seq_len(self) -> int:
        return int(self.manifest["seq_len"])

    @property
    def input_size(self) -> int:
        return int(self.manifest["input_size"])

    @property
    def batch_sizes(self) -> list[int]:
        return list(self._modules)

    @property
    def max_batch(self) -> int:
        return max(self._modules)

    def bucket_for(self, n: int) -> int:
        """Smallest exported bucket >= n (the shape that will run)."""
        for b in self._modules:
            if b >= n:
                return b
        raise ValueError(
            f"batch of {n} exceeds the largest exported bucket "
            f"{self.max_batch}; re-export with a larger batch size")

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor):
        """(cuts, distributions) of (B, L, F) float32 features on the
        device, B an exported bucket. Graphed, the outputs are the graph's
        own, which the next forward of that bucket overwrites."""
        batch = x.shape[0]
        if batch not in self._modules:
            raise ValueError(f"no exported bucket of {batch}; buckets {self.batch_sizes}")
        if not self.graphs:
            return self._modules[batch](x)
        return self._buckets(x)

    @torch.inference_mode()
    def prepare(self, batch_size: int) -> None:
        """Ready the bucket that serves `batch_size` lists before traffic:
        capture its graph (graphed), or run it once (eager)."""
        b = self.bucket_for(batch_size)
        if self.graphs:
            self._buckets.prepare(b)
        else:
            self._forward(torch.zeros(b, self.seq_len, self.input_size, device=self.device))

    def predict_with_distribution(self, x):
        """(B, L, F) features -> ((B,) 1-based cuts, cut distributions)."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        b = self.bucket_for(n)
        if b > n:
            x = np.concatenate([x, np.zeros((b - n,) + x.shape[1:], x.dtype)])
        ks, dist = self._forward(torch.from_numpy(x).to(self.device))
        return ks.cpu().numpy()[:n], dist.cpu().numpy()[:n]

    def predict(self, x) -> np.ndarray:
        return self.predict_with_distribution(x)[0]


def read_manifest(bundle_dir: str) -> dict:
    with open(os.path.join(bundle_dir, MANIFEST)) as f:
        return json.load(f)


def load_exported(bundle_dir: str,
                  device: str | torch.device | None = None) -> ExportedPredictor:
    """Load a bundle written by `save_exported`, to serve on `device` (the
    card unless the caller passes "cpu"). Fails at once, not at the first
    request, if the bundle was written by another format version or
    exported for another device."""
    manifest = read_manifest(bundle_dir)
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"bundle {bundle_dir}: format_version "
            f"{manifest.get('format_version')} != {FORMAT_VERSION}")
    device = resolve_device(device)
    if manifest.get("device") != device.type:
        raise ValueError(
            f"bundle {bundle_dir} was exported for device {manifest.get('device')!r}, "
            f"and this predictor serves on {device.type!r}; re-export with "
            f"--device {device.type} or serve on {manifest.get('device')!r}")
    # `library`, imported with this module, has registered the rlt:: ops
    # the programs call
    programs = {int(b): _placed(torch.export.load(_bucket_path(bundle_dir, int(b))), device)
                for b in manifest["batch_sizes"]}
    return ExportedPredictor(manifest, programs, device)


def _placed(program, device: torch.device):
    """`program` with every weight on `device`: a bundle lowered on a host
    with no card holds its weights on the CPU (`lower_for_card`); one
    exported on its device holds them there already."""
    for state in (program.state_dict, program.constants):
        for key, value in state.items():
            if isinstance(value, torch.Tensor) and value.device.type != device.type:
                moved = value.to(device)
                state[key] = (torch.nn.Parameter(moved, requires_grad=value.requires_grad)
                              if isinstance(value, torch.nn.Parameter) else moved)
    return program


def main(argv=None):
    import argparse

    from rlt_tpu_torch.config import TrainConfig
    from rlt_tpu_torch.infer import COMPUTE_DTYPES, Predictor

    p = argparse.ArgumentParser(description="rlt_tpu_torch serving export")
    p.add_argument("--model-name", type=str, default="attncut")
    p.add_argument("--model-path", type=str, default=None,
                   help="torch state_dict file (training's --model-persist, or "
                   "scripts/jax_checkpoint_to_torch.py's output)")
    p.add_argument("--retrieve-data", type=str, default="robust04")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=tuple(COMPUTE_DTYPES))
    p.add_argument("--batch-sizes", type=str, default="1,8,64,256")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="the device the bundle is exported for, and runs on")
    p.add_argument("--lower", action="store_true",
                   help="with --device cuda: build the Predictor on the CPU and lower "
                   "its programs for the card under fake tensors, which needs no card "
                   "(the JAX CLI's --platforms tpu)")
    p.add_argument("--out", type=str, required=True, help="bundle directory")
    p.add_argument("--check", action="store_true",
                   help="reload the bundle and hold it against the live "
                   "predictor on a random batch")
    args = p.parse_args(argv)

    cfg = TrainConfig(model_name=args.model_name, model_path=args.model_path,
                      retrieve_data=args.retrieve_data,
                      compute_dtype=args.compute_dtype)
    if args.lower and args.device != "cuda":
        p.error("--lower lowers a bundle for --device cuda")
    if args.lower and args.check:
        p.error("--check holds the bundle against the live Predictor on its device; "
                "--lower builds that Predictor on the CPU")
    predictor = Predictor(cfg, device="cpu" if args.lower else args.device)
    sizes = [int(s) for s in args.batch_sizes.split(",") if s]
    manifest = save_exported(args.out, predictor, sizes, device=args.device)
    print(json.dumps(manifest))
    if args.check:
        loaded = load_exported(args.out, device=args.device)
        rng = np.random.default_rng(0)
        x = rng.normal(size=(min(sizes), cfg.seq_len, cfg.input_size)).astype(np.float32)
        ks, dist = loaded.predict_with_distribution(x)
        ks_live, dist_live = predictor.predict_with_distribution(x)
        np.testing.assert_array_equal(ks, ks_live)
        print(json.dumps({"check": "ok", "cuts_equal": True,
                          "max_abs_err": float(np.abs(dist - dist_live).max()),
                          "bit_equal": bool(np.array_equal(dist, dist_live))}))


if __name__ == "__main__":
    main()
