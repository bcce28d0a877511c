"""Offline feature pipeline (reference data_prep/document_statics.ipynb).

A numpy copy of the JAX package's `data/features.py` (host code there
too), kept in the port so that it never imports that package; equal inputs
give byte-identical features (tests/test_torch_data_prep.py).

The reference builds, per ranked list position, statistical features: document
length, unique-token length, and the mean cosine similarity between a document
and its ranked-list neighbors under two representations (tf-idf and doc2vec) —
cells 13, 19-29, 44-57, assembled at 72-79. Here the same features are
vectorized numpy over precomputed document vectors; no gensim dependency:
tf-idf comes from raw token counts, and any dense embedding matrix (doc2vec or
otherwise) can be passed to `neighbor_cosine_similarity` directly.
"""

from __future__ import annotations

import numpy as np


def doc_stats(token_lists: list[list[str]]) -> np.ndarray:
    """(len, unique len) per document (document_statics.ipynb cell 13)."""
    return np.asarray(
        [[len(toks), len(set(toks))] for toks in token_lists], dtype=np.float32
    )


def build_vocab(token_lists: list[list[str]]) -> dict[str, int]:
    vocab: dict[str, int] = {}
    for toks in token_lists:
        for tok in toks:
            vocab.setdefault(tok, len(vocab))
    return vocab


def corpus_idf(token_lists: list[list[str]]) -> dict[str, float]:
    """idf = log2(N / df) over the whole corpus (gensim's default), computed
    from document-frequency counts — no matrix materialized."""
    n_docs = len(token_lists)
    df: dict[str, int] = {}
    for toks in token_lists:
        for tok in set(toks):
            df[tok] = df.get(tok, 0) + 1
    return {tok: float(np.log2(max(n_docs / d, 1.0))) for tok, d in df.items()}


def tfidf_sparse(token_lists: list[list[str]], idf: dict[str, float]):
    """Per-document L2-normalized tf-idf as sparse dicts token -> weight."""
    out = []
    for toks in token_lists:
        tf: dict[str, float] = {}
        for tok in toks:
            tf[tok] = tf.get(tok, 0.0) + 1.0
        vec = {tok: c * idf.get(tok, 0.0) for tok, c in tf.items()}
        norm = float(np.sqrt(sum(w * w for w in vec.values())))
        if norm > 0:
            vec = {tok: w / norm for tok, w in vec.items()}
        out.append(vec)
    return out


def _sparse_cos(a: dict[str, float], b: dict[str, float]) -> float:
    if len(b) < len(a):
        a, b = b, a
    return float(sum(w * b.get(tok, 0.0) for tok, w in a.items()))


def tfidf_vectors(token_lists: list[list[str]], vocab: dict[str, int] | None = None):
    """Dense tf-idf matrix (num_docs, vocab) for small corpora / tests.

    idf is computed over `token_lists` itself; rows L2-normalized so cosine
    similarity is a plain dot product. For ranked-list-scale feature building
    use the sparse pipeline (`corpus_idf` + `tfidf_sparse`) instead."""
    if vocab is None:
        vocab = build_vocab(token_lists)
    n_docs, n_vocab = len(token_lists), len(vocab)
    tf = np.zeros((n_docs, n_vocab), dtype=np.float32)
    for i, toks in enumerate(token_lists):
        for tok in toks:
            j = vocab.get(tok)
            if j is not None:
                tf[i, j] += 1.0
    df = np.count_nonzero(tf > 0, axis=0).astype(np.float32)
    idf = np.log2(np.maximum(n_docs / np.maximum(df, 1.0), 1.0))
    mat = tf * idf
    norms = np.linalg.norm(mat, axis=1, keepdims=True)
    return mat / np.maximum(norms, 1e-12), vocab


def neighbor_cosine_similarity(doc_vectors: np.ndarray) -> np.ndarray:
    """Mean cosine similarity of each ranked doc with its list neighbors.

    doc_vectors: (L, D) vectors in ranked order (one query's list). Position i
    averages cos(i, i-1) and cos(i, i+1); the endpoints use their single
    neighbor — matching document_statics.ipynb cells 44-57. Returns (L,).
    """
    v = doc_vectors.astype(np.float32)
    norms = np.linalg.norm(v, axis=1, keepdims=True)
    v = v / np.maximum(norms, 1e-12)
    sim_next = np.sum(v[:-1] * v[1:], axis=1)  # cos(i, i+1), length L-1
    length = v.shape[0]
    out = np.zeros((length,), dtype=np.float32)
    if length < 2:  # a single-doc list has no neighbors
        return out
    out[0] = sim_next[0]
    out[-1] = sim_next[-1]
    if length > 2:
        out[1:-1] = 0.5 * (sim_next[:-1] + sim_next[1:])
    return out


def _neighbor_cos_sparse(vecs: list[dict[str, float]]) -> np.ndarray:
    """neighbor_cosine_similarity over sparse (already normalized) vectors."""
    length = len(vecs)
    sim_next = np.asarray(
        [_sparse_cos(vecs[i], vecs[i + 1]) for i in range(length - 1)],
        dtype=np.float32,
    )
    out = np.zeros((length,), dtype=np.float32)
    if length < 2:  # a single-doc list has no neighbors
        return out
    out[0] = sim_next[0]
    out[-1] = sim_next[-1]
    if length > 2:
        out[1:-1] = 0.5 * (sim_next[:-1] + sim_next[1:])
    return out


def build_stat_features(
    token_lists_per_query: dict[str, list[list[str]]],
    embeddings_per_query: dict[str, np.ndarray] | None = None,
    include_doc_stats: bool = True,
) -> dict[str, np.ndarray]:
    """Assemble the attncut feature block per query: [doc_len, unique_len,
    tfidf_neighbor_sim[, embedding_neighbor_sim]] (ipynb cells 72-79).

    ``include_doc_stats=False`` gives the 2-feature neighbor-sim-only variant
    [tfidf_sim, d2v_sim] of data_review.ipynb cells 19-20 (`simi_list`).

    tf-idf uses corpus-level idf (the reference trains one tf-idf model on the
    whole corpus, document_statics.ipynb cells 19-21) and stays sparse — no
    (total_docs x vocab) dense matrix."""
    all_docs = [t for toks in token_lists_per_query.values() for t in toks]
    idf = corpus_idf(all_docs)
    out = {}
    for qid, toks in token_lists_per_query.items():
        vecs = tfidf_sparse(toks, idf)
        cols = [] if not include_doc_stats else [doc_stats(toks)]
        cols.append(_neighbor_cos_sparse(vecs)[:, None])
        if embeddings_per_query is not None:
            cols.append(neighbor_cosine_similarity(embeddings_per_query[qid])[:, None])
        out[qid] = np.concatenate(cols, axis=1).astype(np.float32)
    return out


def build_bicut_features(
    token_lists_per_query: dict[str, list[list[str]]],
) -> dict[str, np.ndarray]:
    """The bicut feature block per query: [doc_len, unique_len,
    dense L2-normalized tf-idf vector] (document_statics.ipynb cells 62-66 —
    the reference's 231448-wide `bicut_<ds>_input.pkl`). The dense width here
    is this corpus's vocabulary size; pair with `prep.write_bicut_layout`."""
    all_docs = [t for toks in token_lists_per_query.values() for t in toks]
    dense_all, _ = tfidf_vectors(all_docs)  # corpus-level idf, one tf-idf model
    out: dict[str, np.ndarray] = {}
    offset = 0
    for qid, toks in token_lists_per_query.items():
        dense = dense_all[offset : offset + len(toks)]
        offset += len(toks)
        out[qid] = np.concatenate([doc_stats(toks), dense], axis=1).astype(np.float32)
    return out
