"""The port's data front-end (rlt_tpu_torch/data/text.py, features.py,
prep.py) against the JAX package's: the stopword list, the cleaning, the
features and `prepare_dataset` bit for bit, and the prep CLI on TREC, raw
bm25-pickle and matchzoo inputs writing the JAX CLI's pickles. doc2vec is
tests/test_torch_doc2vec.py's."""

import pickle
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from sklearn.feature_extraction.text import ENGLISH_STOP_WORDS

from rlt_tpu.data import features as jax_features
from rlt_tpu.data import prep as jax_prep
from rlt_tpu.data import text as jax_text
from rlt_tpu_torch.data import features, prep, text
from torch_threads import one_torch_thread  # noqa: F401

TEXTS = [
    "The U.S.A. market-share rose 12% in 2019; marketshare\n"
    "data (really!) beats usa data &hyph; rocket, rocket",
    "Neural networks networks: deep/deep \"learning\" learning -- x y zz zz",
    "tabs\tand\rreturns\\slashes&blank;slashes 'quoted' quoted [brackets] brackets",
    "",
]


def _tokens(seed, docs, words=30, length=12):
    rng = np.random.default_rng(seed)
    vocab = [f"tok{chr(97 + i % 26)}{chr(97 + i // 26)}" for i in range(words)]
    return [rng.choice(vocab, size=length).tolist() for _ in range(docs)]


def test_stopwords_are_the_jax_set():
    assert text.STOPWORDS == jax_text.STOPWORDS
    assert text.STOPWORDS >= frozenset(ENGLISH_STOP_WORDS) and len(text.STOPWORDS) == 337


@pytest.mark.parametrize("drop_hapax", [True, False])
def test_cleaning_equals_the_jax_package(drop_hapax):
    for t in TEXTS:
        assert text.clean_text(t, drop_hapax=drop_hapax) == jax_text.clean_text(
            t, drop_hapax=drop_hapax)
    docset = {"d1": {"title": TEXTS[1], "abstractText": TEXTS[0]}, "d2": TEXTS[2],
              "d3": {"title": "only title title"}}
    assert text.corpus_from_docset(docset) == jax_text.corpus_from_docset(docset)
    ranked = {"q1": {"d2": 0.9, "d1": 0.5, "missing": 0.1}}
    tokens = text.corpus_from_docset(docset)
    assert text.tokens_for_ranked(ranked, tokens) == jax_text.tokens_for_ranked(ranked, tokens)


def _same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    else:
        assert a == b


def test_features_equal_the_jax_package_bit_for_bit():
    per_query = {"q1": _tokens(1, 7) + [[]], "q2": _tokens(2, 5), "q3": _tokens(3, 1)}
    docs = [t for toks in per_query.values() for t in toks]
    rng = np.random.default_rng(4)
    emb = {q: rng.normal(size=(len(t), 8)).astype(np.float32) for q, t in per_query.items()}
    for name, args in (("doc_stats", (docs,)), ("build_vocab", (docs,)),
                       ("corpus_idf", (docs,)), ("tfidf_vectors", (docs,)),
                       ("neighbor_cosine_similarity", (emb["q1"],)),
                       ("neighbor_cosine_similarity", (emb["q3"],)),
                       ("build_bicut_features", (per_query,))):
        _same(getattr(features, name)(*args), getattr(jax_features, name)(*args))
    idf = features.corpus_idf(docs)
    _same(features.tfidf_sparse(docs, idf), jax_features.tfidf_sparse(docs, idf))
    for kwargs in ({}, {"embeddings_per_query": emb}, {"include_doc_stats": False}):
        _same(features.build_stat_features(per_query, **kwargs),
              jax_features.build_stat_features(per_query, **kwargs))


def _run(seed, queries=6, docs=12):
    rng = np.random.default_rng(seed)
    run, rel, tokens = {}, {}, {}
    for qi in range(queries):
        qid = f"q{qi}"
        run[qid] = {f"{qid}_d{j}": float(rng.random()) for j in range(docs - (qi == 0) * 4)}
        rel[qid] = {d for d in run[qid] if rng.random() < 0.3} if qi != 1 else set()
        tokens[qid] = _tokens(seed + qi, 10)  # the kept top 10, in order
    return run, rel, tokens


def test_prepare_dataset_equals_the_jax_package():
    run, rel, tokens = _run(5)
    for kwargs in ({}, {"token_lists": tokens}):
        got = prep.prepare_dataset(run, rel, seq_len=10, **kwargs)
        want = jax_prep.prepare_dataset(run, rel, seq_len=10, **kwargs)
        _same(got, want)
    ranked = got[0]
    emb = {q: np.random.default_rng(6).normal(size=(10, 8)).astype(np.float32)
           for q in ranked}
    _same(prep.prepare_dataset(run, rel, tokens, emb, seq_len=10),
          jax_prep.prepare_dataset(run, rel, tokens, emb, seq_len=10))
    # the port's doc2vec adds the fourth column; the other three are JAX's
    _, _, stats = prep.prepare_dataset(run, rel, tokens, seq_len=10, train_embeddings=True,
                                       doc2vec_kwargs={"vector_size": 8, "min_count": 1,
                                                       "epochs": 2}, device="cpu")
    for q, s in stats.items():
        assert s.shape == (10, 4) and np.isfinite(s).all()
        _same(s[:, :3].copy(), want[2][q])


def _tree(root: Path) -> dict:
    """Every pickle under `root`, loaded, by relative path."""
    out = {}
    for path in sorted(root.rglob("*.pkl")):
        with open(path, "rb") as f:
            out[str(path.relative_to(root))] = pickle.load(f)
    return out


def _raw_bm25_query(qid, n_docs, relevant_ranks):
    docs = [{"doc_id": f"{qid}_d{r}", "rank": r + 1, "bm25_score": 10.0 - 0.01 * r,
             "norm_bm25_score": 5.0 - 0.01 * r, "is_relevant": r in relevant_ranks}
            for r in range(n_docs)]
    return {"query_id": qid, "query_text": f"query {qid}",
            "relevant_documents": [d["doc_id"] for d in docs if d["is_relevant"]],
            "num_rel": len(relevant_ranks), "retrieved_documents": docs,
            "num_ret": n_docs, "num_rel_ret": len(relevant_ranks)}


def _inputs(tmp_path):
    """The three input formats, and a docset of raw text."""
    rng = np.random.default_rng(7)
    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel"]
    run_lines, qrel_lines, docset = [], [], {}
    for qi in range(9):
        for r in range(12 - (qi == 8) * 5):
            doc = f"q{qi}_d{r}"
            run_lines.append(f"q{qi} Q0 {doc} {r + 1} {float(rng.random()):.5f} tag")
            qrel_lines.append(f"q{qi} 0 {doc} {int(rng.random() < 0.3 and qi != 7)}")
            picked = rng.choice(words, size=5).tolist()
            docset[doc] = {"title": " ".join(picked + picked[:3]),
                           "abstractText": f"The {picked[0]}-{picked[1]} 1994 U.S. report."}
    (tmp_path / "run.txt").write_text("\n".join(run_lines) + "\n")
    (tmp_path / "qrels.txt").write_text("\n".join(qrel_lines) + "\n")
    with open(tmp_path / "docset.pkl", "wb") as f:
        pickle.dump(docset, f)
    with open(tmp_path / "raw.pkl", "wb") as f:
        pickle.dump({"queries": [_raw_bm25_query("301", 12, {0}),
                                 _raw_bm25_query("302", 5, {1}),
                                 _raw_bm25_query("303", 12, set()),
                                 _raw_bm25_query("304", 12, {1, 4}),
                                 _raw_bm25_query("305", 12, {2})]}, f)
    rows = [{"id_left": q, "id_right": f"{q}_d{j}", "relation_score": float(rng.random())}
            for q in ("301", "302", "303", "304") for j in range(10 + (q == "302") * 2)]
    with open(tmp_path / "mz.pkl", "wb") as f:
        pickle.dump(pd.DataFrame(rows).sample(frac=1.0, random_state=0), f)
    with open(tmp_path / "gt.pkl", "wb") as f:
        pickle.dump({q: [f"{q}_d0", f"{q}_d3"] for q in ("301", "302", "304")}, f)


@pytest.mark.parametrize("source", [
    ["--run", "run.txt", "--qrels", "qrels.txt"],
    ["--run", "run.txt", "--qrels", "qrels.txt", "--docset-pkl", "docset.pkl"],
    ["--bm25-pickles", "raw.pkl"],
    ["--matchzoo-pkl", "mz.pkl", "--gt-pkl", "gt.pkl"]],
    ids=["trec", "trec-docset", "bm25-pickles", "matchzoo"])
def test_prep_cli_writes_the_jax_pickles(source, tmp_path, monkeypatch, capsys):
    _inputs(tmp_path)
    monkeypatch.chdir(tmp_path)
    common = ["--dataset-name", "bm25", "--seq-len", "10", "--seed", "3"]
    prep.main(source + ["--out", "port", "--device", "cpu"] + common)
    jax_prep.main(source + ["--out", "jax"] + common)
    said = capsys.readouterr().out.splitlines()
    assert said[0].replace("port", "jax") == said[1]
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got and list(got) == list(want)
    for name in got:
        _same(got[name], want[name])
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_prep_cli_trains_embeddings_on_the_requested_device(tmp_path, monkeypatch):
    """--train-embeddings appends the port's doc2vec neighbor similarity to
    the JAX CLI's three stat columns; --device cpu trains it here (the
    default, the card, raises without one)."""
    _inputs(tmp_path)
    monkeypatch.chdir(tmp_path)
    source = ["--run", "run.txt", "--qrels", "qrels.txt", "--docset-pkl", "docset.pkl",
              "--seq-len", "10"]
    prep.main(source + ["--out", "port", "--device", "cpu", "--train-embeddings"])
    jax_prep.main(source + ["--out", "jax"])
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert list(got) == list(want)
    for name in got:
        if Path(name).parts[1] in ("attncut", "mtcut"):  # the stat features
            for q, rows in got[name].items():
                rows = np.asarray(rows, np.float32)
                assert rows.shape == (10, 4) and np.all(np.abs(rows[:, 3]) <= 1 + 1e-5)
                _same(rows[:, :3].copy(), np.asarray(want[name][q], np.float32))
        else:
            _same(got[name], want[name])
