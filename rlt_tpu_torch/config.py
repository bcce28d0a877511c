"""Configuration system (a copy of the JAX package's `config.py`).

Replicates the reference's two-layer config: argparse defaults (run.py:304-329)
overridden by per-model sections of `hyper_parameter_<dataset>.conf`
(run.py:339-347), here as one dataclass plus built-in presets carrying the
exact published values of hyper_parameter_drmm_tks.conf / _bm25.conf. A
configparser reader is provided so the original .conf files keep working.
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    # data (reference run.py:305-307)
    retrieve_data: str = "robust04"  # 'robust04' | 'mq2007'
    dataset_name: str = "drmm_tks"   # 'bm25' | 'drmm' | 'drmm_tks'
    dataset_base: Optional[str] = None  # pkl root; None -> synthetic data
    synthetic_queries: int = 250      # used when dataset_base is None
    batch_size: int = 63

    # model (run.py:309, :327)
    model_name: str = "mmoecut"
    num_tasks: float = 3.0            # 3 | 2.1 (class+cut) | 2.2 (rerank+cut)
    dropout: float = 0.1

    # loss (run.py:310-312, :328-329)
    criterion: str = "dcg"            # reward metric: 'f1' | 'dcg'
    div_type: str = "js"
    augmented_reward: bool = True
    # optional override of the dispatched loss for single-task models
    # ('attncut' | 'choopy' | 'div' | 'wass'); the reference hardwires the
    # choice per model with alternatives left commented out (run.py:73-75)
    loss_override: Optional[str] = None
    rerank_weight: float = 0.3
    class_weight: float = 0.4

    # optimization (run.py:317-320)
    epochs: int = 80
    lr: float = 3e-5
    weight_decay: float = 0.005
    seed: int = 0

    # checkpoint / logging (run.py:313-316, :322)
    model_path: Optional[str] = None
    model_persist: bool = False
    save_path: str = "./best_model/"
    # the metrics log's directory; None writes no log (the JAX package's
    # default is "./runs/", which its trainer always writes)
    log_dir: Optional[str] = None
    draw: bool = False

    # hyper-parameter search (run.py:323-326)
    parameter_search: bool = False
    regularizer_search: bool = False
    mt_search: bool = False
    search_times: int = 300
    # None -> search mode derives '<model>_<corpus>_<ds>_<criterion>_params.log'
    # (run.py:350); set explicitly to append to a chosen file instead
    parameter_record: Optional[str] = None

    # shape overrides (None -> derived from retrieve_data / model family,
    # reference run.py:34, :60, :70, :86); set explicitly for tiny test shapes
    seq_len_override: Optional[int] = None
    input_size_override: Optional[int] = None

    # execution: "bfloat16" serves (the Predictor casts the parameters and
    # the features to bf16 and runs the bf16 kernels) and trains (the
    # Trainer keeps f32 master parameters and casts them and the features
    # to bf16 inside each step, through the bf16 kernels forward and
    # backward; losses and metrics stay f32). The JAX package's TPU switches (use_pallas,
    # fast_dropout_rng, scan_block_epochs) have no meaning here: the port
    # always runs its CUDA kernels on a CUDA tensor and their plain
    # versions on a CPU tensor.
    compute_dtype: str = "float32"
    # shard the batch over the launch's processes, one a card
    # (rlt_tpu_torch/parallel/mesh.py)
    data_parallel: bool = False
    # >1 adds a 'model' mesh axis (with data_parallel): expert-parallel MMOE
    # stacks when num_experts divides it, Megatron FFN tensor parallelism
    # otherwise (rlt_tpu_torch/parallel/sharding.py)
    model_parallel: int = 1

    @property
    def seq_len(self) -> int:
        # run.py:34
        if self.seq_len_override is not None:
            return self.seq_len_override
        return 300 if self.retrieve_data == "robust04" else 40

    @property
    def input_size(self) -> int:
        # run.py:60, :70, :86 — feature width per model family. Choopy-family
        # models always consume scores only (F=1): the cp_dataloader yields
        # (N, L, 1) on every corpus and the model's 127-dim learned PE fills
        # d_model=128 (models/Choopy.py:10,19-20).
        if self.input_size_override is not None:
            return self.input_size_override
        if self.model_name in ("choopy", "mtchoopy"):
            return 1
        if self.retrieve_data == "robust04":
            return 3
        if self.model_name in ("mmoecut", "moecut", "mtple", "probe_base"):
            return 47
        return 25


def loader_family(model_name: str, retrieve_data: str) -> str:
    """(model, corpus) -> dataloader family, the single source of the rule
    the reference spreads over run.py:59-102's per-model branches:
    choopy-family models read scores-only pkls via cp_dataloader (run.py:70);
    the MMOE family reads the 47-feature mtcut pkls on non-robust04 corpora
    (run.py:86-88); everything else reads at_dataloader's layout (run.py:61,
    :74 — bicut shares it, run.py:61-62)."""
    if model_name in ("choopy", "mtchoopy"):
        return "choopy"
    if retrieve_data != "robust04" and model_name in (
        "mmoecut", "moecut", "mtple", "probe_base"
    ):
        return "mtcut"
    return "attncut"


# Exact values of hyper_parameter_drmm_tks.conf (the published-results config).
_DRMM_TKS_PRESETS = {
    "bicut":    dict(batch_size=63, lr=1e-4, weight_decay=0.0024756345581373493, dropout=0.01),
    "choopy":   dict(batch_size=63, lr=1e-3, weight_decay=0.0024756345581373493, dropout=0.1),
    "mtchoopy": dict(batch_size=63, lr=1e-3, weight_decay=0.0024756345581373493, dropout=0.1,
                     rerank_weight=0.5, class_weight=0.5),
    "mtattncut": dict(batch_size=63, lr=3e-5, weight_decay=0.0024756345581373493, dropout=0.1,
                      rerank_weight=0.5, class_weight=0.5),
    "attncut":  dict(batch_size=63, lr=3e-5, weight_decay=0.0014756345581373493, dropout=0.1),
    "mmoecut":  dict(batch_size=63, lr=3e-5, weight_decay=0.0, dropout=0.1,
                     rerank_weight=0.4, class_weight=0.6),
    "moecut":   dict(batch_size=63, lr=3e-5, weight_decay=0.0024756345581373493, dropout=0.0,
                     rerank_weight=0.2, class_weight=0.8),
    "mtple":    dict(batch_size=63, lr=3e-5, weight_decay=0.0, dropout=0.1,
                     rerank_weight=0.5, class_weight=0.7),
    "probe_base": dict(batch_size=63, lr=3e-5, weight_decay=0.0, dropout=0.1,
                       rerank_weight=0.4, class_weight=0.6),
}

# Exact values of hyper_parameter_bm25.conf.
_BM25_PRESETS = {
    "bicut":    dict(batch_size=64, lr=1e-4, weight_decay=0.0024756345581373493, dropout=0.01),
    "choopy":   dict(batch_size=64, lr=1e-3, weight_decay=0.0054756345581373493, dropout=0.2),
    "mtchoopy": dict(batch_size=64, lr=1e-3, weight_decay=0.0024756345581373493, dropout=0.1,
                     rerank_weight=0.5, class_weight=0.5),
    "mtattncut": dict(batch_size=64, lr=3e-5, weight_decay=0.0024756345581373493, dropout=0.1,
                      rerank_weight=0.5, class_weight=0.5),
    "attncut":  dict(batch_size=64, lr=3e-5, weight_decay=0.0019306977288832496,
                     dropout=0.32503772565249145),
    "mmoecut":  dict(batch_size=64, lr=3e-5, weight_decay=0.0024756345581373493, dropout=0.1,
                     rerank_weight=0.2, class_weight=0.8),
    "moecut":   dict(batch_size=64, lr=3e-5, weight_decay=0.0024756345581373493, dropout=0.1,
                     rerank_weight=0.5, class_weight=0.5),
}

PRESETS = {"drmm_tks": _DRMM_TKS_PRESETS, "bm25": _BM25_PRESETS}


def apply_preset(cfg: TrainConfig) -> TrainConfig:
    """Override lr/batch_size/dropout/weight_decay (+ task weights) from the
    built-in preset table, mirroring run.py:339-347."""
    table = PRESETS.get(cfg.dataset_name, _DRMM_TKS_PRESETS)
    preset = table.get(cfg.model_name)
    if preset is None:
        return cfg
    updates = dict(preset)
    if cfg.retrieve_data != "robust04":
        updates.pop("batch_size", None)  # run.py:342 only overrides for robust04
    if "m" not in cfg.model_name:
        updates.pop("rerank_weight", None)
        updates.pop("class_weight", None)
    return dataclasses.replace(cfg, **updates)


def load_conf_file(cfg: TrainConfig, path: str) -> TrainConfig:
    """Read a reference-format hyper_parameter_*.conf and apply the model's
    section, mirroring run.py:339-347 key-for-key."""
    parser = configparser.ConfigParser()
    parser.read(path)
    section = f"{cfg.model_name}_conf"
    updates: dict = {"lr": parser.getfloat(section, "lr")}
    if cfg.retrieve_data == "robust04":
        updates["batch_size"] = parser.getint(section, "batch_size")
    updates["dropout"] = parser.getfloat(section, "dropout")
    updates["weight_decay"] = parser.getfloat(section, "weight_decay")
    from rlt_tpu_torch.models import is_multi_head

    if is_multi_head(cfg.model_name):
        updates["rerank_weight"] = parser.getfloat(section, "rerank_weight")
        updates["class_weight"] = parser.getfloat(section, "class_weight")
    return dataclasses.replace(cfg, **updates)
