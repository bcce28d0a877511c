"""The port's data, metrics, Predictor and serving daemon (rlt_tpu_torch)
against the JAX package, on tiny CPU shapes."""

import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlt_tpu import infer as jax_infer
from rlt_tpu.config import TrainConfig as JaxTrainConfig
from rlt_tpu.data import datasets as jax_datasets
from rlt_tpu.train import decode_ks as jax_decode_ks
from rlt_tpu.utils import metrics as jax_metrics
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.data import datasets
from rlt_tpu_torch.infer import Predictor, decode_ks
from rlt_tpu_torch.serve import TruncationService, bucket_size, make_server
from rlt_tpu_torch.train import Trainer
from rlt_tpu_torch.utils import metrics
from rlt_tpu_torch.utils.convert import params_from_jax
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def tiny_cfg(**kw):
    return TrainConfig(model_name="mmoecut", seq_len_override=16,
                       input_size_override=3, **kw)


@pytest.fixture(scope="module")
def service():
    return TruncationService(tiny_cfg(), max_batch=8, device="cpu")


# ---------------------------------------------------------------------------
# data and metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("retrieve_data,dataset_name,seed", [
    ("robust04", "drmm_tks", 0), ("robust04", "drmm_tks_hard", 3),
    ("mq2007", "bm25", 1)])
def test_synthetic_dataset_is_byte_identical(retrieve_data, dataset_name, seed):
    cfg = datasets.synthetic_config(retrieve_data, dataset_name)
    assert cfg == jax_datasets.synthetic_config(retrieve_data, dataset_name)
    kw = dict(num_queries=20, seq_len=40, num_features=3, seed=seed, **cfg)
    got, want = datasets.synthetic_dataset(**kw), jax_datasets.synthetic_dataset(**kw)
    for name in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    labels = (rng.random((6, 30)) < 0.3).astype(np.float32)
    labels[0] = 0.0  # a list with no relevant document
    ks = rng.integers(1, 31, size=6).astype(np.int32)
    valid = np.array([1, 1, 0, 1, 1, 0], np.float32)
    tl, tk, tv = map(torch.from_numpy, (labels, ks, valid))
    jl, jk, jv = map(jnp.asarray, (labels, ks, valid))
    pairs = [
        (metrics.f1_curve(tl), jax_metrics.f1_curve(jl)),
        (metrics.dcg_curve(tl), jax_metrics.dcg_curve(jl)),
        (metrics.dcg_discount(30), jax_metrics.dcg_discount(30)),
        (metrics.f1_at_k(tl, tk), jax_metrics.f1_at_k(jl, jk)),
        (metrics.dcg_at_k(tl, tk, valid=tv), jax_metrics.dcg_at_k(jl, jk, valid=jv)),
        (metrics.f1_at_k(tl, tk, valid=tv), jax_metrics.f1_at_k(jl, jk, valid=jv)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_decoding_matches_jax():
    rng = np.random.default_rng(1)
    heads = [rng.random((5, 12, 1)).astype(np.float32) for _ in range(3)]
    got = decode_ks("mmoecut", [torch.from_numpy(h) for h in heads])
    want = jax_decode_ks("mmoecut", [jnp.asarray(h) for h in heads])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bicut = rng.random((6, 12, 2)).astype(np.float32)
    bicut[0, :, 1] = 2.0  # every position says continue -> k = L
    bicut[1, 3:, 0] = 2.0  # first truncate at position 3 -> k = 4
    np.testing.assert_array_equal(
        metrics.decode_cut_bicut(torch.from_numpy(bicut)).numpy(),
        np.asarray(jax_metrics.decode_cut_bicut(jnp.asarray(bicut))))


# ---------------------------------------------------------------------------
# Predictor
# ---------------------------------------------------------------------------

def test_predictor_matches_jax_predictor():
    jax_cfg = JaxTrainConfig(model_name="mmoecut", seq_len_override=16,
                             input_size_override=3, use_pallas=False)
    jax_pred = jax_infer.Predictor(jax_cfg)
    port = Predictor(tiny_cfg(), device="cpu",
                     state_dict=params_from_jax(jax.tree.map(np.asarray, jax_pred.params)))
    x = np.random.default_rng(2).normal(size=(5, 16, 3)).astype(np.float32)
    ks, dist = port.predict_with_distribution(x)
    want_ks, want_dist = jax_pred.predict_with_distribution(x)
    np.testing.assert_array_equal(ks, want_ks)
    np.testing.assert_allclose(dist, want_dist, rtol=0, atol=1e-5)


def test_predictor_refuses_what_is_not_ported(tmp_path):
    # bf16 serves (tests/test_torch_bf16.py) and trains
    # (tests/test_torch_bf16_train.py); a dtype the port has no kernels for
    # is refused
    assert Trainer(tiny_cfg(compute_dtype="bfloat16"), device="cpu").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer(tiny_cfg(compute_dtype="float16"), device="cpu")
    with pytest.raises(FileNotFoundError, match="refusing"):
        Predictor(tiny_cfg(model_path=str(tmp_path / "missing.pt")), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        Predictor(tiny_cfg(), device="cpu").forward_ms(1)


def test_predictor_loads_a_state_dict_file(tmp_path):
    src = Predictor(tiny_cfg(seed=7), device="cpu")
    path = tmp_path / "mmoecut.pt"
    torch.save(src.model.state_dict(), path)
    loaded = Predictor(tiny_cfg(model_path=str(path)), device="cpu")
    x = np.random.default_rng(3).normal(size=(2, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(loaded.predict_with_distribution(x)[1],
                                  src.predict_with_distribution(x)[1])


def test_port_imports_no_jax_and_needs_a_card(tmp_path):
    """In a fresh interpreter: the port and chip_smoke.py pull in no jax,
    flax, optax, rlt_tpu or sklearn module, and a Predictor, doc2vec and a
    bundle's loader with no device refuse to run without CUDA instead of
    moving to the CPU."""
    code = """
import sys
import torch
import rlt_tpu_torch, rlt_tpu_torch.serve, rlt_tpu_torch.infer
import rlt_tpu_torch.ops, rlt_tpu_torch.utils.convert, rlt_tpu_torch.data
import rlt_tpu_torch.train, rlt_tpu_torch.utils.losses, rlt_tpu_torch.data.batching
import rlt_tpu_torch.export, rlt_tpu_torch.ops.library, rlt_tpu_torch.data.prep
import rlt_tpu_torch.data.doc2vec, rlt_tpu_torch.data.features, rlt_tpu_torch.data.text
import chip_smoke
bad = sorted(m for m in sys.modules if m.split('.')[0] in (
    'jax', 'jaxlib', 'flax', 'optax', 'rlt_tpu', 'sklearn'))
assert not bad, bad
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.data.doc2vec import train_doc2vec
from rlt_tpu_torch.export import load_exported
from rlt_tpu_torch.infer import Predictor
if not torch.cuda.is_available():
    for name, run in (("Predictor", lambda: Predictor(TrainConfig(seq_len_override=16))),
                      ("doc2vec", lambda: train_doc2vec([["a", "a"]], vector_size=4)),
                      ("load_exported", lambda: load_exported(sys.argv[1]))):
        try:
            run()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError(name + " ran without a card or a CPU request")
print("ok")
"""
    bundle = tmp_path / "bundle"  # a CPU bundle's manifest: no fallback to it either
    bundle.mkdir()
    (bundle / "manifest.json").write_text(json.dumps({"format_version": 1, "device": "cpu"}))
    out = subprocess.run([sys.executable, "-c", code, str(bundle)], cwd=REPO,
                         capture_output=True, text=True, timeout=120, env=ONE_THREAD_ENV)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# The serving daemon (the cases of tests/test_serve.py that involve no export)
# ---------------------------------------------------------------------------

def test_bucket_size():
    assert [bucket_size(n, 8) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    with pytest.raises(ValueError, match="exceeds max_batch"):
        bucket_size(9, 8)


def test_truncate_ragged_lists(service):
    rng = np.random.default_rng(0)
    body = {"features": [rng.normal(size=(16, 3)).tolist(),
                         rng.normal(size=(5, 3)).tolist(),
                         rng.normal(size=(11, 3)).tolist()]}
    out = service.truncate(body)
    assert len(out["k"]) == 3
    assert out["bucket"] == 4
    for k, length in zip(out["k"], (16, 5, 11)):
        assert 1 <= k <= length


def test_truncate_matches_predictor(service):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 16, 3)).astype(np.float32)
    direct = service.predictor.predict(x)
    out = service.truncate({"features": x.tolist()})
    np.testing.assert_array_equal(np.asarray(out["k"]), direct)


def test_distribution_sliced_to_true_length(service):
    rng = np.random.default_rng(2)
    out = service.truncate({"features": [rng.normal(size=(7, 3)).tolist()],
                            "return_distribution": True})
    assert len(out["distribution"]) == 1
    assert len(out["distribution"][0]) == 7


def test_scores_shorthand_for_score_only_models():
    svc = TruncationService(TrainConfig(model_name="mmoecut", seq_len_override=16,
                                        input_size_override=1),
                            max_batch=4, device="cpu")
    out = svc.truncate({"scores": [[0.9, 0.5, 0.3, 0.1]]})
    assert len(out["k"]) == 1 and 1 <= out["k"][0] <= 4
    with pytest.raises(ValueError, match="send 'features'"):
        TruncationService(tiny_cfg(), max_batch=4, device="cpu").truncate(
            {"scores": [[0.9, 0.5]]})


def test_input_validation(service):
    with pytest.raises(ValueError, match="exceeds the model's seq_len"):
        service.truncate({"features": [np.zeros((17, 3)).tolist()]})
    with pytest.raises(ValueError, match="positions x"):
        service.truncate({"features": [np.zeros((4, 2)).tolist()]})
    with pytest.raises(ValueError, match="'features' or 'scores'"):
        service.truncate({})
    with pytest.raises(ValueError, match="exceeds max_batch"):
        service.truncate({"features": np.zeros((9, 4, 3)).tolist()})


def test_microbatch_coalesces_and_matches(service):
    from concurrent.futures import ThreadPoolExecutor

    svc = TruncationService(tiny_cfg(), max_batch=8, microbatch=True,
                            max_wait_ms=250.0, device="cpu")
    try:
        rng = np.random.default_rng(4)
        bodies = [{"features": [rng.normal(size=(16, 3)).tolist()]} for _ in range(6)]
        svc.truncate({"features": [np.zeros((16, 3)).tolist()]})
        base_dispatches = svc.dispatches
        with ThreadPoolExecutor(max_workers=6) as pool:
            outs = list(pool.map(svc.truncate, bodies))
        seq = [service.truncate(b) for b in bodies]
        assert [o["k"] for o in outs] == [s["k"] for s in seq]
        assert svc.dispatches - base_dispatches < 6
        assert svc.lists_served == 7
        assert svc.stats()["dispatches"] == svc.dispatches
    finally:
        svc.close()


def test_microbatch_single_request_and_errors():
    svc = TruncationService(tiny_cfg(), max_batch=4, microbatch=True,
                            max_wait_ms=1.0, device="cpu")
    try:
        out = svc.truncate({"features": [np.zeros((5, 3)).tolist()]})
        assert len(out["k"]) == 1
        with pytest.raises(ValueError, match="exceeds max_batch"):
            svc.truncate({"features": np.zeros((5, 4, 3)).tolist()})
    finally:
        svc.close()
    with pytest.raises(RuntimeError, match="shutting down"):
        svc.truncate({"features": [np.zeros((5, 3)).tolist()]})


def test_http_roundtrip(service):
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address
    base = f"http://{host}:{port}"
    try:
        health = json.load(urllib.request.urlopen(f"{base}/healthz"))
        assert health["ok"] and health["model"] == "mmoecut"
        rng = np.random.default_rng(3)
        payload = json.dumps({"features": [rng.normal(size=(6, 3)).tolist()]}).encode()
        req = urllib.request.Request(f"{base}/truncate", data=payload,
                                     headers={"Content-Type": "application/json"})
        out = json.load(urllib.request.urlopen(req))
        assert len(out["k"]) == 1 and 1 <= out["k"][0] <= 6
        bad = urllib.request.Request(f"{base}/truncate", data=b'{"nope": 1}',
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad)
        assert e.value.code == 400
        stats = json.load(urllib.request.urlopen(f"{base}/stats"))
        assert stats["requests"] >= 1
        assert stats["latency_ms"]["p50"] is not None
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
    assert not thread.is_alive()


def test_infer_cli_on_cpu(tmp_path, capsys):
    from rlt_tpu_torch.infer import main

    out = tmp_path / "cuts.json"
    main(["--device", "cpu", "--retrieve-data", "mq2007", "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["model"] == "mmoecut" and line["device"] == "cpu"
    saved = json.loads(out.read_text())
    assert saved["n_lists"] == len(saved["cuts"]) > 0
    assert all(1 <= k <= 40 for k in saved["cuts"])


def test_parallel_imports_no_jax_and_refuses_a_silent_single_process():
    """In a fresh interpreter: `rlt_tpu_torch.parallel` (the mesh, the
    sharding, the collectives, the dry run) pulls in no jax, flax, optax or
    rlt_tpu module; and `--data-parallel 1` without a card, or on the CPU
    without a launcher, raises instead of training as one process."""
    code = """
import sys
import torch
import torch.distributed as dist
import rlt_tpu_torch.parallel, rlt_tpu_torch.parallel.sharding
import rlt_tpu_torch.parallel.functional, rlt_tpu_torch.parallel.dryrun
bad = sorted(m for m in sys.modules if m.split('.')[0] in (
    'jax', 'jaxlib', 'flax', 'optax', 'rlt_tpu', '__graft_entry__'))
assert not bad, bad
from rlt_tpu_torch import train
args = ["--data-parallel", "1", "--retrieve-data", "mq2007", "--synthetic-queries", "8",
        "--epochs", "1"]
for extra, message in ((["--device", "cpu"], "needs one process per rank"),
                       ([] if not torch.cuda.is_available() else None, "CUDA")):
    if extra is None:
        continue
    try:
        train.main(args + extra)
    except RuntimeError as e:
        assert message in str(e), e
    else:
        raise AssertionError(f"--data-parallel 1 {extra} ran as one process")
    assert not dist.is_initialized()
print("ok")
"""
    env = {k: v for k, v in ONE_THREAD_ENV.items() if k not in ("RANK", "WORLD_SIZE")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
