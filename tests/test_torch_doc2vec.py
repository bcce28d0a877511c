"""The port's doc2vec (rlt_tpu_torch/data/doc2vec.py, PV-DBOW in PyTorch)
against the JAX package's jitted PV-DBOW, on the CPU.

The two draw their random bits from different generators (torch's and
JAX's), so the comparisons are: the vocabulary and the negative-sampling
CDF equal; the inverse-CDF draw equal on the same uniforms; epochs on the
JAX package's own batched pairs equal to JAX's `_epoch` to rounding, with
no random draw (negatives = 0) and with 5 negatives drawn from JAX's own
per-step uniforms; and the geometry the JAX package's tests pin
(tests/test_doc2vec.py), at its thresholds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlt_tpu.data import doc2vec as jax_doc2vec
from rlt_tpu.data.features import neighbor_cosine_similarity as jax_neighbor_sim
from rlt_tpu_torch.data import doc2vec
from rlt_tpu_torch.data.features import build_stat_features, neighbor_cosine_similarity
from torch_threads import one_torch_thread, torch_threads  # noqa: F401

# The port's epoch against JAX's on the same pairs and tables, as the max
# abs difference over the table's max abs: the two sum each dot product
# and each repeated row in another order, so they part by a few float32
# roundings of the update (measured ~1e-7); an element-wise relative bound
# would read the cancellation of an element near 0 as an error.
EPOCH_REL = 1e-6


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _two_topic_corpus(rng, docs_per_topic=12, doc_len=30):
    topic_a = [f"apple{i}" for i in range(20)]
    topic_b = [f"boat{i}" for i in range(20)]
    corpus, labels = [], []
    for t, words in enumerate([topic_a, topic_b]):
        for _ in range(docs_per_topic):
            corpus.append(list(rng.choice(words, size=doc_len)))
            labels.append(t)
    return corpus, np.asarray(labels)


def _train(corpus, **kw):
    return doc2vec.train_doc2vec(corpus, device="cpu", **kw)


def test_vocab_and_negative_cdf_equal_the_jax_package():
    rng = np.random.default_rng(0)
    corpus = [list(rng.choice([f"w{i}" for i in range(40)], size=25)) for _ in range(12)]
    for min_count in (1, 2, 3):
        vocab = doc2vec.build_doc2vec_vocab(corpus, min_count)
        assert vocab == jax_doc2vec.build_doc2vec_vocab(corpus, min_count)
        pairs, counts = doc2vec._corpus_pairs(corpus, vocab)
        jax_pairs, jax_counts = jax_doc2vec._corpus_pairs(corpus, vocab)
        assert np.array_equal(pairs, jax_pairs) and np.array_equal(counts, jax_counts)
    port = _train(corpus, vector_size=8, epochs=1)
    want = jax_doc2vec.train_doc2vec(corpus, vector_size=8, epochs=1)
    assert port.vocab == want.vocab
    assert port.neg_cdf.dtype == want.neg_cdf.dtype == np.float32
    assert port.neg_cdf.tobytes() == want.neg_cdf.tobytes()
    assert (port.lr, port.negatives, port.seed) == (want.lr, want.negatives, want.seed)


def test_searchsorted_equals_jax_on_the_same_uniforms():
    rng = np.random.default_rng(1)
    cdf = doc2vec.negative_cdf(rng.integers(1, 50, size=300).astype(np.float64))
    u = rng.random((64, 5)).astype(np.float32)
    u[0, :3] = [0.0, cdf[17], np.nextafter(np.float32(1.0), np.float32(0.0))]
    want = np.asarray(jnp.searchsorted(jnp.asarray(cdf), jnp.asarray(u)))
    got = torch.searchsorted(torch.from_numpy(cdf), torch.from_numpy(u))
    assert np.array_equal(got.numpy(), want)
    # the negatives: JAX's gather clamps an index past the last word
    drawn = doc2vec.draw_negatives(torch.from_numpy(cdf), torch.from_numpy(u))
    assert np.array_equal(drawn.numpy(), np.minimum(want, len(cdf) - 1))


def _epoch_tables(seed=2, dim=16):
    """A small corpus's pairs, negative CDF and starting tables."""
    rng = np.random.default_rng(seed)
    corpus = [list(rng.choice([f"w{i}" for i in range(60)], size=40)) for _ in range(30)]
    vocab = doc2vec.build_doc2vec_vocab(corpus)
    pairs, counts = doc2vec._corpus_pairs(corpus, vocab)
    cdf = doc2vec.negative_cdf(counts)
    d0 = rng.uniform(-0.5 / dim, 0.5 / dim, (len(corpus), dim)).astype(np.float32)
    w0 = rng.uniform(-0.5 / dim, 0.5 / dim, (len(vocab), dim)).astype(np.float32)
    return pairs, cdf, d0, w0


def _assert_tables_near(got, want, start):
    for g, w, s in zip(got, want, start):
        w = np.asarray(w)
        assert np.abs(w - s).max() > 1e-3  # the epochs moved the table
        assert np.abs(g.numpy() - w).max() <= EPOCH_REL * np.abs(w).max()


def test_epoch_at_no_negatives_equals_the_jax_epoch():
    """Two epochs at negatives = 0 on the JAX package's batched pairs (its
    host permutation from one seed), from the same tables: the port's SGD
    steps equal JAX's `_epoch` to rounding."""
    pairs, cdf, d0, w0 = _epoch_tables()
    jd, jw, td, tw = jnp.asarray(d0), jnp.asarray(w0), torch.from_numpy(d0), torch.from_numpy(w0)
    perm = np.random.default_rng(3)
    for epoch in range(2):
        batched = doc2vec.corpus_batches(pairs, 64, perm)
        lr = 0.025 * (1.0 - epoch / 2)
        jd, jw = jax_doc2vec._epoch(jd, jw, jnp.asarray(batched), jnp.asarray(cdf), lr,
                                    jax.random.PRNGKey(epoch), 0)
        td, tw = doc2vec.epoch(td, tw, torch.from_numpy(batched), torch.from_numpy(cdf), lr,
                               torch.Generator().manual_seed(epoch), 0)
    _assert_tables_near((td, tw), (jd, jw), (d0, w0))


def test_epoch_on_the_jax_uniforms_equals_the_jax_epoch():
    """Two epochs at 5 negatives: JAX's `_epoch` draws each step's
    uniforms from `jax.random.split(key, num_batches)`; the same uniforms,
    turned into word ids by the port's `draw_negatives`, through the port's
    steps (`epoch_steps`) give JAX's tables to rounding. This holds the
    negative half of the gradient (the negatives' rows of d's gradient, and
    their own rows, scattered into the table) to `jax.grad`."""
    negatives = 5
    pairs, cdf, d0, w0 = _epoch_tables()
    jd, jw, td, tw = jnp.asarray(d0), jnp.asarray(w0), torch.from_numpy(d0), torch.from_numpy(w0)
    no_neg = (torch.from_numpy(d0), torch.from_numpy(w0))
    uniform = jax.jit(jax.vmap(lambda k: jax.random.uniform(k, (64, negatives))))
    perm = np.random.default_rng(3)
    for epoch in range(2):
        batched = doc2vec.corpus_batches(pairs, 64, perm)
        lr = 0.025 * (1.0 - epoch / 2)
        key = jax.random.PRNGKey(epoch)
        jd, jw = jax_doc2vec._epoch(jd, jw, jnp.asarray(batched), jnp.asarray(cdf), lr,
                                    key, negatives)
        u = np.array(uniform(jax.random.split(key, batched.shape[0])))
        neg = doc2vec.draw_negatives(torch.from_numpy(cdf), torch.from_numpy(u))
        td, tw = doc2vec.epoch_steps(td, tw, torch.from_numpy(batched), neg, lr)
        no_neg = doc2vec.epoch_steps(*no_neg, torch.from_numpy(batched),
                                     neg[..., :0], lr)
    _assert_tables_near((td, tw), (jd, jw), (d0, w0))
    # the negatives moved the tables far past the bound
    for with_neg, without in zip((jd, jw), no_neg):
        assert np.abs(np.asarray(with_neg) - without.numpy()).max() > 100 * EPOCH_REL


def test_the_epoch_leaves_its_inputs_and_repeats():
    rng = np.random.default_rng(4)
    corpus = [list(rng.choice([f"w{i}" for i in range(30)], size=20)) for _ in range(10)]
    a = _train(corpus, vector_size=8, min_count=1, epochs=3, seed=7)
    b = _train(corpus, vector_size=8, min_count=1, epochs=3, seed=7)
    np.testing.assert_array_equal(a.docvecs, b.docvecs)
    np.testing.assert_array_equal(a.wordvecs, b.wordvecs)
    assert not np.array_equal(a.docvecs, _train(corpus, vector_size=8, min_count=1,
                                                 epochs=3, seed=8).docvecs)


def test_the_cpu_epoch_repeats_on_several_threads():
    """On the CPU with several torch threads an epoch still adds each
    step's rows in one order: three runs of two epochs at 5 negatives and
    vector_size 200 (past the size at which torch's CPU scatter-add goes
    parallel, with atomics) are bit-equal."""
    pairs, cdf, d0, w0 = _epoch_tables(dim=200)
    batched = torch.from_numpy(doc2vec.corpus_batches(pairs, 64, np.random.default_rng(3)))
    runs = []
    with torch_threads(4):
        for _ in range(3):
            d, w = torch.from_numpy(d0), torch.from_numpy(w0)
            g = torch.Generator().manual_seed(5)
            for lr in (0.025, 0.0125):
                d, w = doc2vec.epoch(d, w, batched, torch.from_numpy(cdf), lr, g, 5)
            runs.append(torch.cat([d, w]))
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_empty_vocab_raises():
    with pytest.raises(ValueError, match="empty vocabulary"):
        _train([["x"], ["y"]], min_count=2, vector_size=8, epochs=1)


def test_no_card_and_no_cpu_request_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is it")
    with pytest.raises(RuntimeError, match="CUDA"):
        doc2vec.train_doc2vec([["a", "b", "a"]], vector_size=8, epochs=1, min_count=1)


def test_trained_docvecs_cluster_by_topic():
    rng = np.random.default_rng(0)
    corpus, labels = _two_topic_corpus(rng)
    model = _train(corpus, vector_size=16, min_count=1, epochs=40, batch_size=128, seed=0)
    assert model.docvecs.shape == (len(corpus), 16)
    assert np.isfinite(model.docvecs).all() and np.isfinite(model.wordvecs).all()
    same, cross = [], []
    for i in range(len(corpus)):
        for j in range(i + 1, len(corpus)):
            (same if labels[i] == labels[j] else cross).append(
                _cos(model.docvecs[i], model.docvecs[j]))
    assert np.mean(same) > np.mean(cross) + 0.2


def test_infer_vector_lands_near_its_topic():
    rng = np.random.default_rng(1)
    corpus, labels = _two_topic_corpus(rng)
    model = _train(corpus, vector_size=16, min_count=1, epochs=15, batch_size=128, seed=0)
    held_out = [f"apple{i}" for i in rng.integers(0, 20, size=30)]
    vec = model.infer_vector(held_out, steps=30)
    assert vec.shape == (16,) and np.isfinite(vec).all()
    sim_a = np.mean([_cos(vec, model.docvecs[i]) for i in np.where(labels == 0)[0]])
    sim_b = np.mean([_cos(vec, model.docvecs[i]) for i in np.where(labels == 1)[0]])
    assert sim_a > sim_b


def test_infer_vector_oov_only_tokens_and_long_documents():
    corpus = [["a", "b", "a"], ["b", "a", "b"]]
    model = _train(corpus, vector_size=8, min_count=1, epochs=2, seed=0)
    vec = model.infer_vector(["zzz", "qqq"])  # no token in the vocabulary
    assert vec.shape == (8,) and np.isfinite(vec).all()
    long_doc = ["a", "b"] * 600  # 1200 tokens > max_len = 512
    assert np.isfinite(model.infer_vector(long_doc, steps=3)).all()


def test_infer_vectors_batched_matches_single():
    corpus = [["a", "b", "c"] * 5, ["c", "b", "a"] * 5, ["b", "c"] * 5]
    model = _train(corpus, vector_size=8, min_count=1, epochs=2, seed=0)
    batch = model.infer_vectors(corpus, steps=5)
    singles = np.stack([model.infer_vector(t, steps=5) for t in corpus])
    np.testing.assert_allclose(batch, singles, rtol=1e-4, atol=1e-7)
    assert not np.allclose(batch[0], batch[2])  # documents draw their own streams


def test_embeddings_per_query_and_the_feature_block():
    rng = np.random.default_rng(2)
    per_query = {
        "301": [list(rng.choice([f"w{i}" for i in range(30)], size=20)) for _ in range(5)],
        "302": [list(rng.choice([f"v{i}" for i in range(30)], size=20)) for _ in range(4)],
    }
    corpus = [t for toks in per_query.values() for t in toks]
    model = _train(corpus, vector_size=8, min_count=1, epochs=3, seed=0)
    emb = doc2vec.doc2vec_embeddings_per_query(model, per_query)
    assert emb["301"].shape == (5, 8) and emb["302"].shape == (4, 8)
    idx = {"301": {i: i for i in range(5)}, "302": {i: 5 + i for i in range(4)}}
    emb_idx = doc2vec.doc2vec_embeddings_per_query(model, per_query, doc_index=idx)
    for qid in per_query:
        np.testing.assert_array_equal(emb[qid], emb_idx[qid])
    feats = build_stat_features(per_query, embeddings_per_query=emb)
    assert feats["301"].shape == (5, 4)
    assert np.isfinite(feats["301"]).all() and (np.abs(feats["301"][:, 3]) <= 1 + 1e-5).all()
    inferred = doc2vec.doc2vec_embeddings_per_query(model, {"301": per_query["301"][:2]},
                                                    infer=True)
    assert inferred["301"].shape == (2, 8)
    with pytest.raises(ValueError, match="doc_index"):
        doc2vec.doc2vec_embeddings_per_query(model, {"q": corpus[:2]})


def _mixture_corpus(rng, n_topics=3, n_docs=90, doc_len=60, vocab_per=40):
    """Documents of continuous topic mixtures (Dirichlet 0.4), and the
    mixtures' cosine overlap of each consecutive pair (as
    tests/test_doc2vec.py makes them)."""
    topics = [[f"t{k}w{i}" for i in range(vocab_per)] for k in range(n_topics)]
    mix = rng.dirichlet([0.4] * n_topics, size=n_docs)
    docs = []
    for i in range(n_docs):
        counts = rng.multinomial(doc_len, mix[i])
        words = [w for k, c in enumerate(counts) for w in rng.choice(topics[k], c)]
        rng.shuffle(words)
        docs.append(words)
    gt = (mix[1:] * mix[:-1]).sum(1) / (
        np.linalg.norm(mix[1:], axis=1) * np.linalg.norm(mix[:-1], axis=1))
    return docs, gt


def test_the_neighbor_feature_tracks_topic_overlap_as_the_jax_one_does():
    """On one mixture corpus the port's doc2vec neighbor-similarity feature
    tracks the topic-overlap ground truth no worse than the JAX package's,
    less 0.05 (the JAX test's margin), both measured here."""
    docs, gt = _mixture_corpus(np.random.default_rng(1))
    kw = dict(vector_size=32, min_count=1, epochs=30, seed=0)
    port = neighbor_cosine_similarity(_train(docs, **kw).docvecs)[1:]
    want = jax_neighbor_sim(jax_doc2vec.train_doc2vec(docs, **kw).docvecs)[1:]
    r_port, r_jax = np.corrcoef(port, gt)[0, 1], np.corrcoef(want, gt)[0, 1]
    assert r_port > 0.5 and r_port >= r_jax - 0.05, (r_port, r_jax)
