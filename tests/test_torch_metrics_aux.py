"""The port's auxiliary-task metrics, baselines, analysis toolkit and
batch_norm against the JAX package's, on the CPU.

Both sides compute in f32 from the same numpy arrays made from fixed seeds:
the rerank DCG sums L terms of +-1/log2(i+2) and the AUC counts pairs
exactly (integers and halves, well inside f32's 2^24), so 1e-6 abs is the
rounding of a sum of at most 64 terms of size <= 1; the greedy k is an
index and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlt_tpu import analysis as jax_analysis
from rlt_tpu import baselines as jax_baselines
from rlt_tpu.utils import batchnorm as jax_batchnorm
from rlt_tpu.utils import metrics as jax_metrics
from rlt_tpu_torch import analysis, baselines
from rlt_tpu_torch.utils import batchnorm
from rlt_tpu_torch.utils import metrics
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-6


def _labels_and_scores(seed: int, batch: int = 12, length: int = 48, ties: bool = False):
    """Binary labels with one all-relevant and one all-irrelevant row, and
    scores; with `ties`, scores on a grid of 8 values, so that most lists
    hold tied scores across relevant and irrelevant documents."""
    rng = np.random.default_rng(seed)
    y = (rng.random((batch, length)) < 0.3).astype(np.float32)
    y[0] = 1.0
    y[1] = 0.0
    s = rng.random((batch, length)).astype(np.float32)
    if ties:
        s = np.round(s * 7) / 7
    return y, s.astype(np.float32)


def _both(fn_port, fn_jax, y, s, valid):
    got = fn_port(torch.from_numpy(y), torch.from_numpy(s),
                  valid=None if valid is None else torch.from_numpy(valid))
    want = fn_jax(jnp.asarray(y), jnp.asarray(s),
                  valid=None if valid is None else jnp.asarray(valid))
    return got.item(), float(want)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "valid_mask"])
@pytest.mark.parametrize("name", ["taskr_metric", "taskc_metric"])
def test_aux_metrics_match_jax(name, masked, ties):
    y, s = _labels_and_scores(1 + 2 * ties + masked, ties=ties)
    valid = None
    if masked:
        valid = np.ones(y.shape[0], np.float32)
        valid[[2, 7, 11]] = 0.0
    got, want = _both(getattr(metrics, name), getattr(jax_metrics, name), y, s, valid)
    assert abs(got - want) <= ATOL, (got, want)
    # the (B, L, 1) head form takes the same path
    got3 = getattr(metrics, name)(torch.from_numpy(y), torch.from_numpy(s)[..., None],
                                  valid=None if valid is None else torch.from_numpy(valid))
    assert got3.item() == got


def test_taskc_metric_is_the_pairwise_auc_and_skips_degenerate_rows():
    """One list by hand: relevant scores (0.9, 0.5), irrelevant (0.5, 0.1):
    pairs 1, 1, 0.5, 1 -> 0.875; the all-relevant row is left out."""
    y = torch.tensor([[1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0]])
    s = torch.tensor([[0.9, 0.5, 0.5, 0.1], [0.1, 0.2, 0.3, 0.4]])
    assert metrics.taskc_metric(y, s).item() == 0.875
    assert metrics.taskc_metric(y[1:], s[1:]).item() == 0.0  # no query counted


def test_taskr_metric_sorts_ties_stably():
    """Tied scores keep the list's order, as JAX's stable argsort of -p."""
    y = torch.tensor([[0.0, 1.0, 0.0]])
    s = torch.tensor([[0.5, 0.5, 0.5]])
    want = (-1.0 / np.log2(2) + 1.0 / np.log2(3) - 1.0 / np.log2(4))
    assert abs(metrics.taskr_metric(y, s).item() - want) <= ATOL
    got, jax_value = _both(metrics.taskr_metric, jax_metrics.taskr_metric,
                           y.numpy(), s.numpy(), None)
    assert abs(got - jax_value) <= ATOL


@pytest.mark.parametrize("metric", ["f1", "dcg"])
def test_baseline_metrics_match_jax(metric):
    y, _ = _labels_and_scores(5, batch=20, length=40)
    yt, yj = torch.from_numpy(y), jnp.asarray(y)
    assert abs(metrics.oracle_score(yt, metric).item()
               - float(jax_metrics.oracle_score(yj, metric))) <= ATOL
    assert int(metrics.greedy_k(yt, metric)) == int(jax_metrics.greedy_k(yj, metric))
    for k in (1, 5, 17, 40):
        assert abs(metrics.fixed_k_score(yt, k, metric).item()
                   - float(jax_metrics.fixed_k_score(yj, k, metric))) <= ATOL


def test_baseline_table_matches_jax():
    rng = np.random.default_rng(6)
    y_train = (rng.random((30, 40)) < 0.25).astype(np.float32)
    y_test = (rng.random((10, 40)) < 0.25).astype(np.float32)
    got = baselines.baseline_table(y_train, y_test, (5, 10, 50), device="cpu")
    want = jax_baselines.baseline_table(y_train, y_test, (5, 10, 50))
    assert list(got) == list(want)
    for key, value in want.items():
        if key.startswith("greedy_k"):
            assert got[key] == value, key
        else:
            assert abs(got[key] - value) <= ATOL, key


@pytest.mark.parametrize("metric", ["f1", "dcg"])
def test_mean_reward_curve_matches_jax(metric):
    y, _ = _labels_and_scores(7, batch=16, length=32)
    np.testing.assert_allclose(analysis.mean_reward_curve(y, metric),
                               jax_analysis.mean_reward_curve(y, metric), rtol=0, atol=ATOL)


def test_numpy_analysis_functions_match_jax():
    y, s = _labels_and_scores(8, batch=16, length=32)
    np.testing.assert_allclose(analysis.irrelevant_proportion_curve(y),
                               jax_analysis.irrelevant_proportion_curve(y), rtol=0, atol=ATOL)
    for tau in (0.35, 1.0):
        np.testing.assert_allclose(analysis.augmented_reward_transform(s * 3, tau),
                                   jax_analysis.augmented_reward_transform(s * 3, tau),
                                   rtol=0, atol=ATOL)
    curves = np.random.default_rng(9).random((3, 4, 6)).astype(np.float32)
    assert analysis.probing_convergence(curves) == jax_analysis.probing_convergence(curves)


def test_batch_norm_matches_jax():
    """Each channel within 1e-6 plus 4 f32 ulps of its largest |x| over its
    standard deviation: x - mean cancels, so the two sides' means, summed in
    another order, part by ulps of |x|, which the normalisation scales by
    1 / std (channel 2, std 0.1 about -1, reads 2.4e-6)."""
    x = (np.random.default_rng(10).normal(size=(6, 20, 3)) * [1.0, 5.0, 0.1]
         + [0.0, 2.0, -1.0]).astype(np.float32)
    got = batchnorm.batch_norm(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_batchnorm.batch_norm(jnp.asarray(x)))
    ulp = np.finfo(np.float32).eps
    limit = ATOL + 4 * ulp * np.abs(x).max(axis=(0, 1)) / x.std(axis=(0, 1))
    assert np.all(np.abs(got - want).max(axis=(0, 1)) <= limit)
    np.testing.assert_allclose(got.mean(axis=(0, 1)), 0.0, atol=ATOL)


def test_plot_reward_curves_writes_a_png(tmp_path):
    y, _ = _labels_and_scores(11, batch=8, length=16)
    path = analysis.plot_reward_curves(y, str(tmp_path / "figs" / "curves.png"))
    assert path is not None and open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_baselines_cli_on_cpu_and_its_default_device(capsys):
    """`python -m rlt_tpu_torch.baselines --device cpu` prints the table; its
    default device is the card, and without one it raises."""
    table = baselines.main(["--device", "cpu", "--retrieve-data", "mq2007",
                            "--fixed-ks", "5", "10"])
    assert set(table) >= {"oracle_f1", "greedy_k_dcg", "fixed_f1@5", "fixed_dcg@10"}
    assert '"oracle_f1"' in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            baselines.main(["--retrieve-data", "mq2007"])
