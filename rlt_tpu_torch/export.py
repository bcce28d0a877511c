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
the JAX version refuses another platform. A bundle for the card is
exported on the card.

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
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

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


def export_bucket(predictor, batch: int):
    """`predictor`'s forward (`infer.Predictor.body`) exported at one static
    batch size on its device, under `torch.no_grad()`."""
    cfg = predictor.cfg
    x = torch.zeros(batch, cfg.seq_len, cfg.input_size, device=predictor.device)
    with torch.no_grad():
        return torch.export.export(predictor.body, (x,), strict=False)


def save_exported(out_dir: str, predictor, batch_sizes=(1, 8, 64, 256)) -> dict:
    """Export `predictor` (`rlt_tpu_torch.infer.Predictor`) at each batch
    size and write the bundle to `out_dir`. Returns the manifest."""
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
    os.makedirs(out_dir, exist_ok=True)
    cfg = predictor.cfg
    custom_ops: set[str] = set()
    for b in batch_sizes:
        program = export_bucket(predictor, b)
        custom_ops.update(_custom_ops(program))
        torch.export.save(program, _bucket_path(out_dir, b))
    manifest = {
        "format_version": FORMAT_VERSION,
        "model_name": cfg.model_name,
        "seq_len": cfg.seq_len,
        "input_size": cfg.input_size,
        "compute_dtype": cfg.compute_dtype,
        "batch_sizes": batch_sizes,
        "device": predictor.device.type,
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
    programs = {int(b): torch.export.load(_bucket_path(bundle_dir, int(b)))
                for b in manifest["batch_sizes"]}
    return ExportedPredictor(manifest, programs, device)


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
    p.add_argument("--out", type=str, required=True, help="bundle directory")
    p.add_argument("--check", action="store_true",
                   help="reload the bundle and hold it against the live "
                   "predictor on a random batch")
    args = p.parse_args(argv)

    cfg = TrainConfig(model_name=args.model_name, model_path=args.model_path,
                      retrieve_data=args.retrieve_data,
                      compute_dtype=args.compute_dtype)
    predictor = Predictor(cfg, device=args.device)
    sizes = [int(s) for s in args.batch_sizes.split(",") if s]
    manifest = save_exported(args.out, predictor, sizes)
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
