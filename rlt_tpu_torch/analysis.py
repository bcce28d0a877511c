"""Truncation analysis toolkit (the JAX package's `analysis.py`; the
reference's Baseline/Truncation_analysis.ipynb).

The notebook studies (1) the reward curves, F1 and DCG as functions of k
(cells 5-9); (2) retrieval bias, the share of irrelevant documents in each
prefix (cells 14-21); (3) probing convergence, the probes' AUC and DCG on
raw and learned representations (cells 22-27, from verify_probe); (4) the
augmented reward exp(r / tau) against exp(r) (cells 38-41). numpy over the
whole corpus, but for the reward curves, which come from the port's
`utils/metrics.py`; figures need matplotlib, imported where they are drawn."""

from __future__ import annotations

import os

import numpy as np
import torch

from rlt_tpu_torch.utils import metrics as metrics_lib


def mean_reward_curve(labels: np.ndarray, metric: str = "f1") -> np.ndarray:
    """The corpus-mean metric at every k, (L,) (cells 5-9)."""
    curve = metrics_lib.reward_matrix(torch.as_tensor(np.asarray(labels)), metric)
    return curve.numpy().mean(axis=0)


def irrelevant_proportion_curve(labels: np.ndarray) -> np.ndarray:
    """The mean share of irrelevant documents in the k-prefix for every k,
    (L,) (retrieval bias, cells 14-21)."""
    labels = np.asarray(labels, dtype=np.float64)
    k = np.arange(1, labels.shape[1] + 1)
    cum_irr = np.cumsum(1.0 - labels, axis=1)
    return (cum_irr / k).mean(axis=0)


def augmented_reward_transform(rewards: np.ndarray, tau: float = 0.35) -> np.ndarray:
    """Row-normalised exp(r / tau), the sharpened reward the notebook sets
    against exp(r) (cells 38-41)."""
    z = np.asarray(rewards, dtype=np.float64) / tau
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


# verify_probe's six probes, in the order of its step metrics
PROBES = ("pre_encoding_classification", "pre_encoding_rerank",
          "expert0_classification", "expert0_rerank",
          "expert1_classification", "expert1_rerank")


def probing_convergence(curves) -> dict:
    """The final and best value of each probe over verify_probe's per-step
    metrics, `curves` (epochs, steps, 6) as `ProbeTrainer.run` returns them
    (cells 22-27 plot these trajectories)."""
    flat = np.asarray(curves)
    flat = flat.reshape(-1, flat.shape[-1])
    return {name: {"final": float(flat[-1, i]), "best": float(flat[:, i].max())}
            for i, name in enumerate(PROBES)}


def plot_reward_curves(labels: np.ndarray, out_path: str = "./figs/reward_curves.png"):
    """The F1 and DCG against k figure (cells 5-9); its path, or None where
    matplotlib does not import."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    f1 = mean_reward_curve(labels, "f1")
    dcg = mean_reward_curve(labels, "dcg")
    x = np.arange(1, f1.shape[0] + 1)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4), dpi=120)
    ax1.plot(x, f1)
    ax1.set_title("mean F1 @ k")
    ax1.set_xlabel("k")
    ax2.plot(x, dcg)
    ax2.set_title("mean DCG @ k")
    ax2.set_xlabel("k")
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
