"""Offline dataset preparation (reference data_prep/*.ipynb as a library).

A copy of the JAX package's `data/prep.py` (host code there too), kept in
the port so that it never imports that package: the same ingestion,
filtering, splits and layout writers, which write the JAX package's pickles
byte for byte (tests/test_torch_data_prep.py). The document vectors of
`--train-embeddings` come from the port's doc2vec (`data/doc2vec.py`),
which trains on the CUDA card unless `--device cpu` is given.

The reference prepares datasets in notebooks: parse retrieval runs into
per-query top-L ranked lists (data_prepare.ipynb cells 13-16, 34-45), build
the ground-truth relevance map (cells 49-50), compute per-document statistical
features (document_statics.ipynb), and write 5-fold 80/20 train/test splits
(cells 12, 16, 45, 64-65). Here the same pipeline is pure functions over
in-memory structures, with `write_reference_layout` emitting the exact pkl
layout the reference loaders (and ours) read.

Ingestion covers all three raw formats: standard TREC run/qrels files (the
interoperable equivalent), the reference's raw bm25 run pickles
(`rob04_bm25_top1000.*.pkl`, cells 34-45), and matchzoo result dataframes
(`drmm_tks.pkl` sorted by relation_score, cells 56-65) — so a holder of the
reference's upstream artifacts can build its datasets end-to-end, including
its exact split_{1..5} fold memberships (`reference_split_dataset`).

Semantics preserved (SURVEY §2.5): queries with fewer than `seq_len` retrieved
docs are DROPPED (not padded); queries with zero relevant docs in the top-L
are dropped; splits are random 80/20 with one seed per fold.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def run_from_trec_file(path: str) -> dict[str, dict[str, float]]:
    """Parse a standard TREC run file ('qid Q0 docid rank score tag' lines)
    into qid -> {doc_id: score}. The reference ingests retrieval runs from
    ad-hoc pickles (data_prepare.ipynb cells 13-16, 34-45); TREC format is the
    interoperable equivalent every IR toolkit emits."""
    run: dict[str, dict[str, float]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:  # the trailing run tag is optional
                continue
            qid, _, doc_id, _, score = parts[:5]
            run.setdefault(qid, {})[doc_id] = float(score)
    return run


def qrels_from_trec_file(path: str) -> dict[str, set]:
    """Parse TREC qrels ('qid 0 docid rel') into qid -> relevant-doc set
    (the reference builds gt.pkl from its own relevance pickles)."""
    gt: dict[str, set] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            qid, _, doc_id, rel = parts[:4]
            if int(rel) > 0:
                gt.setdefault(qid, set()).add(doc_id)
            else:
                gt.setdefault(qid, set())
    return gt


def ranked_lists_from_run(run: dict[str, dict[str, float]], seq_len: int = 300):
    """run: qid -> {doc_id: score} (any order) -> qid -> ordered dict of the
    top-seq_len docs by descending score. Queries with < seq_len docs are
    dropped (data_prepare.ipynb cells 14, 43, 63)."""
    out = {}
    for qid, doc_scores in run.items():
        if len(doc_scores) < seq_len:
            continue
        ranked = sorted(doc_scores.items(), key=lambda kv: -kv[1])[:seq_len]
        out[qid] = dict(ranked)
    return out


def filter_queries_with_relevance(ranked: dict, gt: dict[str, set]) -> dict:
    """Drop queries whose top-L list contains no relevant doc
    (data_prepare.ipynb cells 15, 44)."""
    out = {}
    for qid, docs in ranked.items():
        rel = gt.get(qid, set())
        if any(d in rel for d in docs):
            out[qid] = docs
    return out


# ---------------------------------------------------------------------------
# The reference's actual raw upstream formats
# ---------------------------------------------------------------------------

def load_bm25_run_pickles(paths) -> list[dict]:
    """Concatenate the `queries` lists of the reference's raw run pickles
    (`rob04_bm25_top1000.{train,dev,test}.s1.pkl`, data_prepare.ipynb cells
    34-37). Each entry: {'query_id', 'query_text', 'relevant_documents',
    'num_rel', 'retrieved_documents', 'num_ret', 'num_rel_ret'}; each
    retrieved document: {'doc_id', 'rank', 'bm25_score', 'norm_bm25_score',
    'is_relevant'}."""
    queries: list[dict] = []
    for path in paths:
        with open(path, "rb") as f:
            queries.extend(pickle.load(f)["queries"])
    return queries


def bm25_queries_to_ranked(queries: list[dict], seq_len: int = 300,
                           score_key: str = "norm_bm25_score"):
    """Raw run queries -> (ranked, gt) for `write_reference_layout`, with the
    notebook's exact semantics (data_prepare.ipynb cells 43-44): keep queries
    with >= seq_len retrieved docs, truncate to the top seq_len IN RETRIEVED
    ORDER (no re-sort), then drop queries whose kept list has no
    `is_relevant` doc. gt maps qid -> relevant_documents set (cells 49-50)."""
    ranked: dict[str, dict[str, float]] = {}
    gt: dict[str, set] = {}
    for item in queries:
        docs = item["retrieved_documents"]
        if len(docs) < seq_len:
            continue
        docs = docs[:seq_len]
        if not any(d["is_relevant"] for d in docs):
            continue
        qid = item["query_id"]
        ranked[qid] = {d["doc_id"]: float(d[score_key]) for d in docs}
        gt[qid] = set(item["relevant_documents"])
    return ranked, gt


def matchzoo_results_to_ranked(df, seq_len: int = 300):
    """The matchzoo result dataframe (`drmm_tks.pkl`: columns id_left,
    id_right, relation_score) -> qid -> {doc_id: score} ranked lists
    (data_prepare.ipynb cells 56-63): per query, docs sorted by descending
    relation_score, queries with < seq_len rows dropped, the rest truncated.
    Relevance is NOT in the frame — pair with gt from qrels or
    `gt_from_pickle` before `filter_queries_with_relevance`."""
    import pandas as pd

    ranked: dict[str, dict[str, float]] = {}
    for qid in pd.unique(df["id_left"]):
        sub = df[df["id_left"] == qid].sort_values(
            by=["relation_score"], ascending=False)
        if len(sub) < seq_len:
            continue
        head = sub.head(seq_len)
        ranked[qid] = {
            doc: float(score)
            for doc, score in zip(head["id_right"], head["relation_score"])
        }
    return ranked


def gt_from_pickle(path: str) -> dict[str, set]:
    """Read the reference's `robust04_gt.pkl` (qid -> list of relevant doc
    ids, data_prepare.ipynb cells 49-50) as qid -> set."""
    with open(path, "rb") as f:
        raw = pickle.load(f)
    return {qid: set(docs) for qid, docs in raw.items()}


def reference_split_dataset(all_data: dict, train_ratio: float = 0.8,
                            seed: int = 1):
    """The notebook's own 80/20 split, bit-for-bit (data_prepare.ipynb cell
    64): seed the stdlib RNG, draw `randint` indices into a SHRINKING key
    list for the train side, remainder is test. Reproduces the reference's
    split_{1..5} memberships exactly given the same input dict order."""
    import random

    rnd = random.Random(seed)
    train_size = int(len(all_data) * train_ratio)
    train, test, keys = {}, {}, list(all_data)
    for _ in range(train_size):
        idx = rnd.randint(0, len(keys) - 1)
        train[keys[idx]] = all_data[keys[idx]]
        keys.pop(idx)
    for key in keys:
        test[key] = all_data[key]
    return train, test


def reference_five_folds(all_data: dict, train_ratio: float = 0.8):
    """split_1..split_5 with seed = fold index, the notebook's convention
    (data_prepare.ipynb cells 45, 65)."""
    return {f"split_{i}": reference_split_dataset(all_data, train_ratio, i)
            for i in range(1, 6)}


def split_dataset(qids: list[str], train_fraction: float = 0.8, seed: int = 0):
    """One 80/20 random split (data_prepare.ipynb cell 12)."""
    rng = np.random.default_rng(seed)
    qids = list(qids)
    perm = rng.permutation(len(qids))
    n_train = int(round(train_fraction * len(qids)))
    train = [qids[i] for i in perm[:n_train]]
    test = [qids[i] for i in perm[n_train:]]
    return train, test


def five_fold_splits(qids: list[str], train_fraction: float = 0.8):
    """split_1..split_5 with distinct seeds (data_prepare.ipynb cells 16, 45,
    64-65)."""
    return {f"split_{i + 1}": split_dataset(qids, train_fraction, seed=i)
            for i in range(5)}


def write_reference_layout(
    base: str,
    retrieve_data: str,
    dataset_name: str,
    ranked: dict[str, dict[str, float]],
    gt: dict[str, set],
    stats: dict[str, np.ndarray] | None = None,
    train_fraction: float = 0.8,
    seed: int = 0,
) -> None:
    """Write <base>/<retrieve_data>/{<ds>_train,<ds>_test,gt}.pkl (+
    attncut/ and mtcut/ stat pkls) in the exact layout the loaders read
    (attncut_dataloader.py:30-40)."""
    db = os.path.join(base, retrieve_data)
    os.makedirs(db, exist_ok=True)
    train_q, test_q = split_dataset(list(ranked), train_fraction, seed)

    def dump(obj, *parts):
        path = os.path.join(db, *parts)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(obj, f)

    dump({q: ranked[q] for q in train_q}, f"{dataset_name}_train.pkl")
    dump({q: ranked[q] for q in test_q}, f"{dataset_name}_test.pkl")
    dump({q: sorted(gt.get(q, set())) for q in ranked}, "gt.pkl")
    if stats is not None:
        for sub in ("attncut", "mtcut"):
            dump({q: np.asarray(stats[q]).tolist() for q in train_q},
                 sub, f"{dataset_name}_train.pkl")
            dump({q: np.asarray(stats[q]).tolist() for q in test_q},
                 sub, f"{dataset_name}_test.pkl")


def write_bicut_layout(
    base: str,
    retrieve_data: str,
    dataset_name: str,
    ranked: dict[str, dict[str, float]],
    stats: dict[str, np.ndarray],
    train_fraction: float = 0.8,
    seed: int = 0,
) -> None:
    """Write the per-query bicut layout the lazy loader reads
    (split_bicut_data.py:13-46 semantics, bicut_dataloader.py:10-26 layout):
    `<base>/<retrieve_data>/bicut/<ds>_<stage>/<qid>.pkl`, each holding that
    query's (L, 1+S) matrix of column_stack((scores, dense stats)). Must be
    paired with `write_reference_layout` (same seed) for the score pkls and
    gt.pkl the loader also reads."""
    db = os.path.join(base, retrieve_data)
    train_q, test_q = split_dataset(list(ranked), train_fraction, seed)
    for stage, qids in (("train", train_q), ("test", test_q)):
        stage_dir = os.path.join(db, "bicut", f"{dataset_name}_{stage}")
        os.makedirs(stage_dir, exist_ok=True)
        for qid in qids:
            scores = np.asarray(list(ranked[qid].values()), dtype=np.float32)
            feat = np.column_stack((scores, np.asarray(stats[qid], np.float32)))
            with open(os.path.join(stage_dir, f"{qid}.pkl"), "wb") as f:
                pickle.dump(feat, f)


def main(argv=None):
    """CLI: raw retrieval results -> reference-layout pkl dataset.

    Three input formats, exactly one required:
      TREC:      --run run.txt --qrels qrels.txt
      raw bm25:  --bm25-pickles rob04_bm25_top1000.train.s1.pkl [...]
                 (the reference's run pickles, data_prepare.ipynb cells 34-45)
      matchzoo:  --matchzoo-pkl drmm_tks.pkl --gt-pkl robust04_gt.pkl
                 (result dataframe + gt pickle, cells 56-65)

    python -m rlt_tpu_torch.data.prep --run run.txt --qrels qrels.txt \
        --out dataset/ --dataset-name bm25 [--seq-len 300] [--device cpu]

    Optionally, document TEXT flows all the way to stat features (the
    document_statics.ipynb cells 5-9 front-end, data/text.py):
      --docset-pkl docset.pkl   {doc_id: {"title","abstractText"} | raw str}
                                — cleaned + tokenized here; or
      --tokens-pkl tokens.pkl   {doc_id: [token, ...]} pre-tokenized.
    Either adds the attncut/mtcut stat-feature pkls to the layout;
    --train-embeddings additionally trains PV-DBOW doc2vec over the kept
    documents (on --device, the card by default) and appends the d2v
    neighbor-sim feature column.
    """
    import argparse

    p = argparse.ArgumentParser(description="rlt_tpu_torch dataset preparation")
    p.add_argument("--run", type=str, help="TREC run file")
    p.add_argument("--qrels", type=str, help="TREC qrels file")
    p.add_argument("--bm25-pickles", type=str, nargs="+",
                   help="reference raw bm25 run pickles (relevance inline)")
    p.add_argument("--matchzoo-pkl", type=str,
                   help="matchzoo result dataframe pickle")
    p.add_argument("--gt-pkl", type=str,
                   help="gt pickle (qid -> relevant doc ids); required "
                        "with --matchzoo-pkl")
    p.add_argument("--docset-pkl", type=str,
                   help="raw document text pickle {doc_id: text-or-fields}; "
                        "cleaned/tokenized into stat features")
    p.add_argument("--tokens-pkl", type=str,
                   help="pre-tokenized documents {doc_id: [token, ...]}")
    p.add_argument("--train-embeddings", action="store_true",
                   help="with --docset-pkl/--tokens-pkl: train doc2vec and "
                        "append the d2v neighbor-sim feature")
    p.add_argument("--out", type=str, required=True, help="output dataset root")
    p.add_argument("--retrieve-data", type=str, default="robust04")
    p.add_argument("--dataset-name", type=str, default="bm25")
    p.add_argument("--seq-len", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="where --train-embeddings trains doc2vec")
    args = p.parse_args(argv)

    sources = [bool(args.run), bool(args.bm25_pickles), bool(args.matchzoo_pkl)]
    if sum(sources) != 1:
        p.error("give exactly one of --run/--qrels, --bm25-pickles, "
                "--matchzoo-pkl")
    if args.bm25_pickles:
        queries = load_bm25_run_pickles(args.bm25_pickles)
        ranked, gt = bm25_queries_to_ranked(queries, seq_len=args.seq_len)
    elif args.matchzoo_pkl:
        if not args.gt_pkl:
            p.error("--matchzoo-pkl requires --gt-pkl")
        with open(args.matchzoo_pkl, "rb") as f:
            df = pickle.load(f)
        gt = gt_from_pickle(args.gt_pkl)
        ranked = matchzoo_results_to_ranked(df, seq_len=args.seq_len)
        ranked = filter_queries_with_relevance(ranked, gt)
        gt = {q: gt.get(q, set()) for q in ranked}
    else:
        if not args.qrels:
            p.error("--run requires --qrels")
        run = run_from_trec_file(args.run)
        gt = qrels_from_trec_file(args.qrels)
        ranked, gt, _ = prepare_dataset(run, gt, seq_len=args.seq_len)

    stats = None
    if args.docset_pkl or args.tokens_pkl:
        if args.docset_pkl and args.tokens_pkl:
            p.error("give at most one of --docset-pkl, --tokens-pkl")
        from rlt_tpu_torch.data.features import build_stat_features
        from rlt_tpu_torch.data.text import corpus_from_docset, tokens_for_ranked

        with open(args.docset_pkl or args.tokens_pkl, "rb") as f:
            table = pickle.load(f)
        doc_tokens = corpus_from_docset(table) if args.docset_pkl else table
        kept_tokens = tokens_for_ranked(ranked, doc_tokens)
        embeddings = None
        if args.train_embeddings:
            from rlt_tpu_torch.data.doc2vec import (
                doc2vec_embeddings_per_query,
                train_doc2vec,
            )

            corpus = [t for toks in kept_tokens.values() for t in toks]
            model = train_doc2vec(corpus, device=args.device)
            embeddings = doc2vec_embeddings_per_query(model, kept_tokens)
        stats = build_stat_features(kept_tokens, embeddings)
    write_reference_layout(args.out, args.retrieve_data, args.dataset_name,
                           ranked, gt, stats=stats, seed=args.seed)
    print(f"wrote {len(ranked)} queries to {args.out}/{args.retrieve_data}"
          + ("" if stats is None else
             f" with {next(iter(stats.values())).shape[1]}-col stat features"))


def prepare_dataset(
    run: dict[str, dict[str, float]],
    relevant: dict[str, set],
    token_lists: dict[str, list[list[str]]] | None = None,
    embeddings: dict[str, np.ndarray] | None = None,
    seq_len: int = 300,
    train_embeddings: bool = False,
    doc2vec_kwargs: dict | None = None,
    device: str | None = None,
):
    """Full pipeline: rank -> drop short/irrelevant queries -> stat features.

    With ``train_embeddings=True`` (and no precomputed ``embeddings``) a
    PV-DBOW doc2vec model is trained over the kept queries' token lists and
    its document vectors feed the d2v neighbor-sim feature — the complete
    document_statics.ipynb pipeline with no gensim. ``doc2vec_kwargs``
    overrides `train_doc2vec` defaults (vector_size=200, min_count=2,
    epochs=40); it trains on `device` (the card unless "cpu").

    Returns (ranked, gt, stats|None) ready for write_reference_layout."""
    from rlt_tpu_torch.data.features import build_stat_features

    ranked = ranked_lists_from_run(run, seq_len)
    ranked = filter_queries_with_relevance(ranked, relevant)
    stats = None
    if token_lists is not None:
        kept_tokens = {q: token_lists[q] for q in ranked}
        if embeddings is None and train_embeddings:
            from rlt_tpu_torch.data.doc2vec import (
                doc2vec_embeddings_per_query,
                train_doc2vec,
            )

            corpus = [t for toks in kept_tokens.values() for t in toks]
            model = train_doc2vec(corpus, **{"device": device, **(doc2vec_kwargs or {})})
            embeddings = doc2vec_embeddings_per_query(model, kept_tokens)
        stats = build_stat_features(
            kept_tokens,
            {q: embeddings[q] for q in ranked} if embeddings else None,
        )
    gt = {q: set(relevant.get(q, set())) for q in ranked}
    return ranked, gt, stats


if __name__ == "__main__":
    main()
