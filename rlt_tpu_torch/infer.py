"""Batched inference: a Predictor over one model family, and its CLI.

The counterpart of the JAX package's `infer.py`: weights + (B, L, F)
features -> per-list cut positions (and the cut distribution). It runs on
the CUDA card unless the caller passes `device="cpu"`, where the kernels'
plain PyTorch versions run instead. Weights come from the model's own seeded
initialisation, a torch state_dict file (`--model-path`; a JAX trainer's
checkpoint becomes one through `scripts/jax_checkpoint_to_torch.py`), or a
JAX parameter tree through `rlt_tpu_torch.utils.convert.params_from_jax`.
The forward (`ForwardBody`) is what `rlt_tpu_torch.export` exports.

`compute_dtype="bfloat16"` serves as the JAX package's `Predictor` does
with it: every float32 parameter and the (B, L, F) features are cast to
bf16, the model runs in bf16 (its LSTM and attention kernels through their
bf16 instances), and its outputs are cast back to float32 before the cuts
are decoded and the distribution returned. The bf16 copy of the model is
made once; `model` stays the float32 master (its state_dict is what a
checkpoint holds). Training in bf16 casts the same way inside each step
(`rlt_tpu_torch/train.py`).

On the card each batch size is one CUDA graph, as the JAX package serves
each shape through one jitted `_predict`: the forward with its casts and
the decode of the cuts, captured at the first forward of that size into a
static (B, L, F) buffer (`rlt_tpu_torch/utils/graphs.py::GraphedBuckets`;
one memory pool for all sizes) and replayed for every forward after it.
`graphs=False` serves eager on the card, for reference runs through
`ops.plain_ops()` (which refuses graphs) and to hold the graphs to. The CPU
serves eager.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.models import build_model, is_multi_head
from rlt_tpu_torch.utils import metrics as metrics_lib
from rlt_tpu_torch.utils.graphs import GraphedBuckets, use_graphs
from rlt_tpu_torch.utils.platform import resolve_device
from rlt_tpu_torch.utils.timing import REPEATS, interleaved_ms


def decode_ks(model_name: str, output) -> torch.Tensor:
    """Predicted cut per row: bicut's first-truncate rule; multi-task models
    decode the LAST head; single-task the lone head."""
    if model_name == "bicut":
        return metrics_lib.decode_cut_bicut(output)
    if is_multi_head(model_name):
        return metrics_lib.decode_cut(output[-1])
    return metrics_lib.decode_cut(output)


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A torch state_dict file written with `torch.save(model.state_dict())`."""
    if not os.path.isfile(path):
        # never serve random weights when the caller asked for trained ones
        raise FileNotFoundError(
            f"--model-path {path!r}: no state_dict file there; refusing to "
            "serve untrained weights")
    return torch.load(path, map_location="cpu", weights_only=True)


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_float32(output):
    """A model's output (a tensor or a list of heads) in float32; a float32
    output as it is."""
    if isinstance(output, (list, tuple)):
        return [o.float() for o in output]
    return output.float()


class ForwardBody(torch.nn.Module):
    """What one serving forward computes, as a module: (B, L, F) float32
    features -> (cuts (B,) int32, distributions). The features are cast to
    the compute dtype, the served module `net` runs, its outputs come back
    in float32, and the cuts are decoded; the distribution is the cut
    head's (B, L), or BiCut's (B, L, 2) decision probabilities. A
    Predictor's graphs capture it, and `rlt_tpu_torch.export` exports it
    whole, its weights held in the program."""

    def __init__(self, net: torch.nn.Module, model_name: str, dtype: torch.dtype):
        super().__init__()
        self.net = net
        self.model_name = model_name
        self.dtype = dtype

    def forward(self, x: torch.Tensor):
        output = to_float32(self.net(x.to(self.dtype)))
        ks = decode_ks(self.model_name, output)
        if self.model_name == "bicut":
            dist = output  # (B, L, 2) decision probabilities
        else:
            cut = output[-1] if is_multi_head(self.model_name) else output
            dist = cut[..., 0] if cut.dim() == 3 else cut
        return ks, dist


class Predictor:
    """Truncation predictor for one model family on one device: each batch
    size one CUDA graph (`graphs`, the default on a CUDA device), or eager
    (False: the CPU's only route). Graphs on the CPU raise. A graphed
    predictor's sizes own static buffers: one forward at a time (the
    server's device lock). `model`: a model built by the caller in place of
    `build_model`'s, as `train.Trainer` takes one (e.g. `build_model(...,
    encoding_size=256, d_model=512, n_head=16)` at widths the config does
    not name)."""

    def __init__(self, cfg: TrainConfig, state_dict=None,
                 device: str | torch.device | None = None, graphs: bool | None = None,
                 model: torch.nn.Module | None = None):
        if cfg.model_name == "probe_base":
            raise ValueError("probe_base is a probing vehicle, not an "
                             "inference model")
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, "
                             f"got {cfg.compute_dtype!r}")
        self.device = resolve_device(device)
        self.graphs = graphs = use_graphs(self.device, graphs)
        self.cfg = cfg
        if model is None:
            model = build_model(cfg.model_name, seq_len=cfg.seq_len,
                                input_size=cfg.input_size, dropout=cfg.dropout,
                                num_tasks=cfg.num_tasks, seed=cfg.seed)
        if state_dict is None and cfg.model_path:
            state_dict = load_state_dict(cfg.model_path)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.dtype = COMPUTE_DTYPES[cfg.compute_dtype]
        # the module that serves: the model itself, or its bf16 copy, made
        # before any capture and never moved after it
        self.net = (self.model if self.dtype == torch.float32
                    else copy.deepcopy(self.model).to(self.dtype))
        self.body = ForwardBody(self.net, cfg.model_name, self.dtype)
        # each batch size's graph, captured at first use
        self._buckets = (GraphedBuckets((cfg.seq_len, cfg.input_size), self.device,
                                        lambda batch: self.body)
                         if graphs else None)

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor):
        """(cuts, distributions) of (B, L, F) float32 features on the
        device. Graphed: x is copied into size B's static input and its
        graph replayed, and the outputs are the graph's own, which the next
        forward of size B overwrites."""
        if not self.graphs:
            return self.body(x)
        return self._buckets(x)

    @torch.inference_mode()
    def prepare(self, batch_size: int) -> None:
        """Ready the forward of `batch_size` lists before traffic: capture
        its graph (graphed), or run it once (eager)."""
        if self.graphs:
            self._buckets.prepare(batch_size)
        else:
            self._forward(torch.zeros(batch_size, self.cfg.seq_len,
                                      self.cfg.input_size, device=self.device))

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32)).to(self.device)

    def predict(self, x) -> np.ndarray:
        """(B, L, F) features -> (B,) 1-based cut positions."""
        return self.predict_with_distribution(x)[0]

    def predict_with_distribution(self, x):
        ks, dist = self._forward(self._to_device(x))
        return ks.cpu().numpy(), dist.cpu().numpy()

    def forward_ms(self, batch_size: int = 256, iters: int = 3,
                   repeats: int = REPEATS) -> float:
        """Device ms of one forward + decode at `batch_size` in the
        predictor's compute dtype (the casts of the features and the outputs
        included; graphed, the copy into the static input and the replay):
        the median over `repeats` rounds of `iters` back-to-back calls
        between two CUDA events (`utils.timing.interleaved_ms`). A device
        measurement: raises off the card."""
        if self.device.type != "cuda":
            raise RuntimeError("forward_ms times the CUDA card; this "
                               f"predictor runs on {self.device}")
        x = torch.zeros(batch_size, self.cfg.seq_len, self.cfg.input_size,
                        device=self.device)
        return interleaved_ms({"forward": lambda: self._forward(x)}, iters,
                              repeats)["forward"]["median"]

    def throughput(self, batch_size: int = 256, iters: int = 3) -> float:
        """Steady-state ranked lists per second at `batch_size` on the card."""
        return batch_size / (self.forward_ms(batch_size, iters) / 1e3)


def main(argv=None):
    """CLI: predict cut positions for a dataset's test split (reference-
    format pkls with --dataset-base, else the calibrated synthetic corpus)."""
    import argparse
    import json

    from rlt_tpu_torch.config import loader_family
    from rlt_tpu_torch.data import load_pkl_dataset, synthetic_config, synthetic_dataset

    p = argparse.ArgumentParser(description="rlt_tpu_torch truncation inference")
    p.add_argument("--model-name", type=str, default="mmoecut")
    p.add_argument("--model-path", type=str, default=None,
                   help="torch state_dict file (torch.save(model.state_dict()))")
    p.add_argument("--dataset-base", type=str, default=None)
    p.add_argument("--retrieve-data", type=str, default="robust04")
    p.add_argument("--dataset-name", type=str, default="drmm_tks")
    p.add_argument("--throughput", action="store_true",
                   help="also report steady-state ranked-lists/sec (card only)")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=tuple(COMPUTE_DTYPES),
                   help="serve with bf16 parameters, features and kernels")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--out", type=str, default=None, help="write JSON here")
    args = p.parse_args(argv)

    cfg = TrainConfig(model_name=args.model_name, model_path=args.model_path,
                      retrieve_data=args.retrieve_data,
                      dataset_name=args.dataset_name,
                      dataset_base=args.dataset_base,
                      compute_dtype=args.compute_dtype)
    family = loader_family(cfg.model_name, cfg.retrieve_data)
    if cfg.dataset_base:
        data = load_pkl_dataset(cfg.dataset_base, cfg.retrieve_data,
                                cfg.dataset_name, family)
    else:
        data = synthetic_dataset(
            num_queries=cfg.synthetic_queries, seq_len=cfg.seq_len,
            num_features=cfg.input_size, seed=cfg.seed,
            **synthetic_config(cfg.retrieve_data, cfg.dataset_name))

    predictor = Predictor(cfg, device=args.device)
    ks = predictor.predict(data.x_test)
    y = torch.as_tensor(data.y_test)
    kt = torch.as_tensor(ks)
    result = {
        "model": cfg.model_name,
        "device": str(predictor.device),
        "compute_dtype": cfg.compute_dtype,
        "n_lists": int(ks.shape[0]),
        "cuts": ks.tolist(),
        "test_f1": float(metrics_lib.f1_at_k(y, kt)),
        "test_dcg": float(metrics_lib.dcg_at_k(y, kt)),
    }
    if args.throughput:
        result["ranked_lists_per_sec"] = predictor.throughput()
        result["device_name"] = torch.cuda.get_device_name(predictor.device)
    print(json.dumps({k: v for k, v in result.items() if k != "cuts"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)


if __name__ == "__main__":
    main()
