"""Reward-distribution figures (the JAX package's `utils/plots.py`, the
reference's run.py:242-298): the batch mean of the normalised reward
distribution exp(r / tau) against the batch mean of the model's normalised
cut distribution, one figure per (model, divergence, augmentation, epoch).
The two curves are drawn as plain polylines into a PNG written with zlib
(`plain_figure`), so that `--draw` needs no plotting package: the JAX
package draws them with matplotlib and draws nothing where it is missing.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from rlt_tpu_torch.utils import metrics as metrics_lib


def reward_and_prediction_curves(labels: np.ndarray, predictions: np.ndarray,
                                 metric: str = "f1", tau: float = 0.9):
    """The batch-mean normalised reward distribution and the batch-mean
    normalised prediction distribution, each (L,) (run.py:263-283)."""
    r = metrics_lib.reward_matrix(torch.as_tensor(np.asarray(labels)), metric).numpy()
    r = np.exp(r / tau)
    norm_r = (r / r.sum(axis=1, keepdims=True)).mean(axis=0)

    z = predictions / (tau * 1e-3)
    z = z - z.max(axis=1, keepdims=True)  # shift-invariant, no overflow in exp
    s = np.exp(z)
    norm_s = (s / s.sum(axis=1, keepdims=True)).mean(axis=0)
    if norm_s.shape[0] > 4:  # run.py:283 flattens the tail
        norm_s[-3:] = norm_s[-4]
    return norm_r, norm_s


def _png(path: str, rgb: np.ndarray) -> None:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG, every row unfiltered."""
    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    height, width, _ = rgb.shape
    rows = b"".join(b"\x00" + row.tobytes() for row in np.ascontiguousarray(rgb, np.uint8))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows, 6)) + chunk(b"IEND", b""))


def plain_figure(path: str, curves, colors, size=(600, 1200), margin: int = 40) -> str:
    """Each (L,) curve as a 3-pixel polyline in its RGB colour on a white
    canvas (height, width) = `size` inside a grey frame, all on one y scale;
    written as a PNG. Returns the path."""
    height, width = size
    img = np.full((height, width, 3), 255, np.uint8)
    img[[margin, height - margin], margin:width - margin + 1] = 160
    img[margin:height - margin + 1, [margin, width - margin]] = 160
    lo = min(float(np.min(c)) for c in curves)
    hi = max(float(np.max(c)) for c in curves)
    span = hi - lo if hi > lo else 1.0
    for curve, color in zip(curves, colors):
        n = len(curve)
        xs = margin + np.arange(n) * (width - 2 * margin) / max(n - 1, 1)
        ys = height - margin - (np.asarray(curve, np.float64) - lo) / span * (height - 2 * margin)
        # each segment sampled at one point a pixel of its longer side
        steps = int(np.ceil(np.abs(np.diff(xs)).max(initial=0)
                            + np.abs(np.diff(ys)).max(initial=0))) + 1
        t = np.linspace(0.0, 1.0, steps)[:, None]
        px = np.rint(xs[:-1] + t * np.diff(xs)).astype(int).ravel() if n > 1 else xs.astype(int)
        py = np.rint(ys[:-1] + t * np.diff(ys)).astype(int).ravel() if n > 1 else ys.astype(int)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                img[np.clip(py + dy, 0, height - 1), np.clip(px + dx, 0, width - 1)] = color
    _png(path, img)
    return path


def plot_reward_vs_prediction(labels: np.ndarray, predictions: np.ndarray, *, metric: str,
                              epoch: int, model_name: str, div_type: str,
                              aug_reward: bool, out_dir: str = "./figs") -> str:
    """Draw the two curves into `out_dir/<model>_<div>_<ar|dr>_<epoch>.png`
    (reward green, prediction blue); the path."""
    norm_r, norm_s = reward_and_prediction_curves(labels, predictions, metric)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{model_name}_{div_type}_{'ar' if aug_reward else 'dr'}_{epoch}.png")
    return plain_figure(path, (norm_r, norm_s), ((50, 205, 50), (123, 104, 238)))
