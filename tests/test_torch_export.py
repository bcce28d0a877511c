"""The port's serving export (rlt_tpu_torch/export.py), its custom ops
(ops/library.py) under `torch.export`, `serve --exported`, and the JAX
checkpoint converter (scripts/jax_checkpoint_to_torch.py), on tiny CPU
shapes (L = 16, F = 3), against the live Predictor and the JAX package.

A bundle reloaded from disk must give the live Predictor's cuts, and its
distributions within 1e-6: on the CPU the exported program runs the same
ops as the live forward, the kernels' plain versions behind the `rlt::`
ops, so they agree to rounding (here bit for bit). Against the JAX
package's own bundle of the same weights, converted with `params_from_jax`:
cuts equal, distributions within 1e-5, the f32 tolerance of the port's
serving parity (tests/test_torch_serve.py)."""

import importlib.util
import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rlt_tpu import export as jax_export
from rlt_tpu import infer as jax_infer
from rlt_tpu.config import TrainConfig as JaxTrainConfig
from rlt_tpu.utils.checkpoint import save_params
from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.export import load_exported, read_manifest, save_exported
from rlt_tpu_torch.infer import Predictor
from rlt_tpu_torch.models import MODELS
from rlt_tpu_torch.serve import TruncationService
from rlt_tpu_torch.utils.convert import params_from_jax
from torch_threads import ONE_THREAD_ENV, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
L, F = 16, 3
# the exported program against the live forward it was traced from
DIST_ATOL = 1e-6
# the port against the JAX package on the same weights (f32)
JAX_ATOL = 1e-5


def tiny_cfg(model_name="mmoecut", **kw):
    return TrainConfig(model_name=model_name, seq_len_override=L,
                       input_size_override=1 if "choopy" in model_name else F, **kw)


def features(seed, n, model_name="mmoecut"):
    width = 1 if "choopy" in model_name else F
    return np.random.default_rng(seed).normal(size=(n, L, width)).astype(np.float32)


def assert_serves_like(loaded, live, x, atol=DIST_ATOL):
    ks, dist = loaded.predict_with_distribution(x)
    want_ks, want_dist = live.predict_with_distribution(x)
    np.testing.assert_array_equal(ks, want_ks)
    assert dist.shape == want_dist.shape
    np.testing.assert_allclose(dist, want_dist, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """MMOECut f32 at buckets 2 and 4, with its live Predictor."""
    out = str(tmp_path_factory.mktemp("bundle") / "mmoecut")
    live = Predictor(tiny_cfg(), device="cpu")
    return out, live, save_exported(out, live, batch_sizes=(4, 2))


@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_every_model_exports_and_serves_like_the_live_predictor(model_name, tmp_path):
    live = Predictor(tiny_cfg(model_name), device="cpu")
    manifest = save_exported(str(tmp_path), live, batch_sizes=(3,))
    loaded = load_exported(str(tmp_path), device="cpu")
    assert not loaded.graphs  # the CPU runs eager
    assert manifest["custom_ops"] and all(op.startswith("rlt::")
                                          for op in manifest["custom_ops"])
    assert_serves_like(loaded, live, features(1, 3, model_name))


@pytest.mark.parametrize("model_name", ["mmoecut", "choopy"])
def test_bf16_bundle_serves_like_the_live_predictor(model_name, tmp_path):
    live = Predictor(tiny_cfg(model_name, compute_dtype="bfloat16"), device="cpu")
    manifest = save_exported(str(tmp_path), live, batch_sizes=(2,))
    assert manifest["compute_dtype"] == "bfloat16"
    assert all(op.endswith("_bf16") for op in manifest["custom_ops"])
    assert_serves_like(load_exported(str(tmp_path), device="cpu"), live,
                       features(2, 2, model_name))


def test_manifest(bundle):
    out, _, manifest = bundle
    assert manifest == read_manifest(out)
    assert manifest["format_version"] == 1 and manifest["model_name"] == "mmoecut"
    assert (manifest["seq_len"], manifest["input_size"]) == (L, F)
    assert manifest["batch_sizes"] == [2, 4] and manifest["compute_dtype"] == "float32"
    assert manifest["device"] == "cpu" and manifest["torch_version"] == torch.__version__
    assert manifest["custom_ops"] == ["rlt::attention_packed_fwd", "rlt::lstm_fwd"]
    for b in (2, 4):
        assert (Path(out) / f"b{b}.pt2").is_file()


def test_the_exported_program_calls_the_ops(bundle):
    out, _, _ = bundle
    program = torch.export.load(str(Path(out) / "b2.pt2"))
    calls = [str(n.target) for n in program.graph.nodes if n.op == "call_function"
             and "rlt." in str(n.target)]
    # two BiLSTM layers, one launch each; one packed attention over the experts
    assert sorted(calls) == ["rlt.attention_packed_fwd.default"] + ["rlt.lstm_fwd.default"] * 2


def test_bucket_padding(bundle):
    """A batch of 3 rides the 4-bucket, 1 the 2-bucket; the pad rows do not
    reach the results; past the largest bucket raises."""
    out, live, _ = bundle
    loaded = load_exported(out, device="cpu")
    assert (loaded.bucket_for(1), loaded.bucket_for(3), loaded.max_batch) == (2, 4, 4)
    for n in (1, 3):
        assert_serves_like(loaded, live, features(3 + n, n))
    with pytest.raises(ValueError, match="largest exported bucket"):
        loaded.predict(features(5, 5))


def test_format_version_and_device_guards(bundle, tmp_path):
    out, _, manifest = bundle
    for name, value, error, match in (("format_version", 999, ValueError, "format_version"),
                                      ("device", "cuda", ValueError, "exported for device")):
        bad = tmp_path / name
        bad.mkdir()
        for f in Path(out).iterdir():
            (bad / f.name).write_bytes(f.read_bytes())
        (bad / "manifest.json").write_text(json.dumps({**manifest, name: value}))
        with pytest.raises(error, match=match):
            load_exported(str(bad), device="cpu")
    # the card unless the CPU is asked for: a CPU bundle is no fallback
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_exported(out)


def test_service_serves_from_the_bundle(bundle):
    """TruncationService over an ExportedPredictor: the live service's cuts
    through the ragged, bucketed path; a request rides the smallest exported
    bucket that holds it; warmup readies each exported bucket."""
    out, _, manifest = bundle
    loaded = load_exported(out, device="cpu")
    cfg = TrainConfig(model_name=manifest["model_name"], seq_len_override=manifest["seq_len"],
                      input_size_override=manifest["input_size"])
    svc = TruncationService(cfg, max_batch=4, predictor=loaded)
    live = TruncationService(tiny_cfg(), max_batch=4, device="cpu")
    assert svc.predictor is loaded and svc.warmup() == [2, 4]
    rng = np.random.default_rng(6)
    body = {"features": [rng.normal(size=(11, F)).tolist(), rng.normal(size=(16, F)).tolist(),
                         rng.normal(size=(7, F)).tolist()], "return_distribution": True}
    got, want = svc.truncate(body), live.truncate(body)
    assert got["k"] == want["k"] and got["bucket"] == 4
    for d, w in zip(got["distribution"], want["distribution"]):
        np.testing.assert_allclose(d, w, rtol=0, atol=DIST_ATOL)
    assert svc.truncate({"features": [rng.normal(size=(5, F)).tolist()]})["bucket"] == 2


# ---------------------------------------------------------------------------
# A bundle for the card lowered on this host, which has no card
# ---------------------------------------------------------------------------

def _calls(program) -> list[str]:
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


def _tensors(program):
    """Every tensor value a program's graph records, by node."""
    for node in program.graph.nodes:
        val = node.meta.get("val")
        for v in val if isinstance(val, (list, tuple)) else (val,):
            if isinstance(v, torch.Tensor):
                yield node, v


@pytest.mark.parametrize("model_name,dtype,widths", [
    ("mmoecut", "float32", {}), ("choopy", "float32", {}), ("mtple", "bfloat16", {}),
    ("mmoecut", "float32", dict(encoding_size=256, d_model=512, n_head=16))])
def test_a_card_bundle_lowers_on_a_host_with_no_card(model_name, dtype, widths, tmp_path):
    """`save_exported(..., device="cuda")` from a Predictor on the CPU: the
    manifest says cuda and lists the rlt:: ops; each program is the CPU
    program's graph, op for op, with every tensor on the card; its weights
    are the live ones, real and on the CPU; no kernel was built or
    launched; and the CPU refuses to serve it."""
    from rlt_tpu_torch.export import export_bucket
    from rlt_tpu_torch.models import build_model
    from rlt_tpu_torch.ops import KERNELS, build

    cfg = tiny_cfg(model_name, compute_dtype=dtype)
    model = (build_model(model_name, seq_len=cfg.seq_len, input_size=cfg.input_size,
                         dropout=cfg.dropout, **widths) if widths else None)
    live = Predictor(cfg, device="cpu", model=model)
    launches = {name: k.launches for name, k in KERNELS.items()}
    manifest = save_exported(str(tmp_path), live, batch_sizes=(1, 3), device="cuda")
    assert manifest["device"] == "cuda" and manifest["batch_sizes"] == [1, 3]
    on_cpu = export_bucket(live, 3)
    assert manifest["custom_ops"] == sorted(
        {f"rlt::{t.split('.')[1]}" for t in _calls(on_cpu) if t.startswith("rlt.")})
    program = torch.export.load(str(tmp_path / "b3.pt2"))
    assert _calls(program) == _calls(on_cpu)
    assert {v.device.type for _, v in _tensors(program)} == {"cuda"}
    live_state = {f"net.{k}": v for k, v in live.net.state_dict().items()}
    assert set(program.state_dict) <= set(live_state)
    for key, value in program.state_dict.items():
        assert value.device.type == "cpu" and torch.equal(value, live_state[key]), key
    assert {name: k.launches for name, k in KERNELS.items()} == launches
    if not torch.cuda.is_available():
        assert build.LIBRARY._lib is None
    with pytest.raises(ValueError, match="exported for device 'cuda'"):
        load_exported(str(tmp_path), device="cpu")


def test_export_cli_lowers_for_the_card_on_a_host_with_no_card(tmp_path):
    """`python -m rlt_tpu_torch.export --device cuda --lower` with no card
    visible writes a bundle for the card. Lowering is asked for, never
    inferred: without `--lower` the same command fails for want of a card
    and writes nothing; `--lower` refuses `--check` and `--device cpu`."""
    env = {**ONE_THREAD_ENV, "CUDA_VISIBLE_DEVICES": ""}
    args = [sys.executable, "-m", "rlt_tpu_torch.export", "--model-name", "bicut",
            "--retrieve-data", "mq2007", "--batch-sizes", "1,2", "--device", "cuda",
            "--out", str(tmp_path / "bicut")]

    def run(extra):
        return subprocess.run(args + extra, cwd=REPO, capture_output=True, text=True,
                              timeout=300, env=env)

    no_card = run([])
    assert no_card.returncode != 0 and "cuda" in no_card.stderr.lower()
    for extra in (["--lower", "--check"], ["--lower", "--device", "cpu"]):
        refused = run(extra)
        assert refused.returncode == 2 and "--lower" in refused.stderr, extra
    assert not (tmp_path / "bicut").exists()
    out = run(["--lower"])
    assert out.returncode == 0, out.stderr
    manifest = json.loads(out.stdout.strip().splitlines()[-1])
    assert manifest == read_manifest(str(tmp_path / "bicut"))
    assert manifest["device"] == "cuda" and manifest["custom_ops"] == ["rlt::lstm_fwd"]


def _get(url, timeout=5):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def test_export_cli_check_and_serve_exported(tmp_path):
    """`python -m rlt_tpu_torch.export --check` writes a bundle and holds it
    against the live predictor; `python -m rlt_tpu_torch.serve --exported`
    serves it over HTTP with the manifest's shapes."""
    bundle_dir = tmp_path / "attncut"
    out = subprocess.run(
        [sys.executable, "-m", "rlt_tpu_torch.export", "--model-name", "attncut",
         "--retrieve-data", "mq2007", "--batch-sizes", "1,4", "--device", "cpu",
         "--out", str(bundle_dir), "--check"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=ONE_THREAD_ENV)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert lines[0]["batch_sizes"] == [1, 4] and lines[0]["seq_len"] == 40
    assert lines[-1]["check"] == "ok" and lines[-1]["max_abs_err"] <= DIST_ATOL

    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "rlt_tpu_torch.serve", "--exported", str(bundle_dir),
         "--device", "cpu", "--port", str(port), "--warmup"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=ONE_THREAD_ENV)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, proc.stderr.read()
            try:
                health = _get(f"{base}/healthz")
                break
            except OSError:
                assert time.time() < deadline, "serve --exported did not come up"
                time.sleep(0.25)
        body = {"features": [np.ones((40, 25)).tolist(), np.ones((12, 25)).tolist()]}
        req = urllib.request.Request(f"{base}/truncate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            got = json.load(r)
        stats = _get(f"{base}/stats")
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()
    assert health["model"] == "attncut" and health["seq_len"] == 40
    assert health["max_batch"] == 4  # capped at the bundle's largest bucket
    live = Predictor(TrainConfig(model_name="attncut", retrieve_data="mq2007"), device="cpu")
    x = np.zeros((4, 40, 25), np.float32)
    x[0], x[1, :12] = 1.0, 1.0
    want = np.minimum(live.predict(x)[:2], [40, 12])
    assert got["k"] == want.tolist() and got["bucket"] == 4
    assert stats["requests"] == 1 and stats["lists_served"] == 2


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def jax_cfg(model_name, **kw):
    return JaxTrainConfig(model_name=model_name, seq_len_override=L, input_size_override=F,
                          use_pallas=False, **kw)


@pytest.mark.parametrize("model_name", ["attncut", "mmoecut", "bicut"])
def test_the_bundle_serves_the_jax_bundles_cuts(model_name, tmp_path):
    """The JAX package's own bundle of its weights, and the port's bundle of
    the same weights converted: the same cuts, distributions within 1e-5."""
    jax_live = jax_infer.Predictor(jax_cfg(model_name))
    jax_export.save_exported(str(tmp_path / "jax"), jax_live, batch_sizes=(4,))
    jax_loaded = jax_export.load_exported(str(tmp_path / "jax"))
    state = params_from_jax(jax.tree.map(np.asarray, jax_live.params))
    live = Predictor(tiny_cfg(model_name), state_dict=state, device="cpu")
    save_exported(str(tmp_path / "port"), live, batch_sizes=(4,))
    loaded = load_exported(str(tmp_path / "port"), device="cpu")
    x = features(7, 3, model_name)
    ks, dist = loaded.predict_with_distribution(x)
    want_ks, want_dist = jax_loaded.predict_with_distribution(x)
    np.testing.assert_array_equal(ks, want_ks)
    np.testing.assert_allclose(dist, want_dist, rtol=0, atol=JAX_ATOL)


def _converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", REPO / "scripts" / "jax_checkpoint_to_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_a_converted_jax_checkpoint_serves_the_jax_cuts(tmp_path, capsys):
    """JAX `save_params` (orbax) -> scripts/jax_checkpoint_to_torch.py -> the
    port's Predictor with `model_path`: the JAX Predictor's cuts on the same
    checkpoint. The weights are the JAX init of another seed, moved, so that
    they are no init the port could rebuild by itself."""
    jax_trained = jax_infer.Predictor(jax_cfg("mmoecut", seed=5))
    params = jax.tree.map(lambda a: a + 0.01 * np.sign(np.asarray(a)), jax_trained.params)
    base = str(tmp_path / "mmoecut")
    written = save_params(base, params)
    assert written.endswith(".orbax")
    out = str(tmp_path / "mmoecut.pt")
    _converter().main(["--model-name", "mmoecut", "--model-path", base, "--out", out,
                       "--seq-len", str(L), "--input-size", str(F)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["out"] == out and summary["leaves"] == len(torch.load(out))
    port = Predictor(tiny_cfg(model_path=out), device="cpu")
    jax_pred = jax_infer.Predictor(jax_cfg("mmoecut", model_path=base))
    x = features(8, 6)
    ks, dist = port.predict_with_distribution(x)
    want_ks, want_dist = jax_pred.predict_with_distribution(x)
    np.testing.assert_array_equal(ks, want_ks)
    np.testing.assert_allclose(dist, want_dist, rtol=0, atol=JAX_ATOL)
    with pytest.raises(FileNotFoundError, match="no .orbax or .msgpack"):
        _converter().convert("mmoecut", str(tmp_path / "absent"), out, seq_len=L,
                             input_size=F)
