"""Dataset construction: pkl ingestion + synthetic generator.

A numpy-only copy of the JAX package's `data/datasets.py`, kept in the port
so that it never imports that package; the arrays are byte-identical for
equal arguments (tests/test_torch_serve.py).

Ingestion reproduces the reference loaders byte-for-byte in semantics:

* attncut family (reference dataloader/attncut_dataloader.py:21-59): scores from
  `<base>/<retrieve_data>/<dataset>_{train,test}.pkl` (qid -> ordered dict
  doc_id -> score), per-position stat features from `attncut/<dataset>_*.pkl`,
  relevance from `gt.pkl` (qid -> relevant doc ids); X = column_stack((scores,
  stats)) per query, y = binary membership of each doc in gt.
* choopy family (choopy_dataloader.py:13-76): scores only, X = (N, L, 1).
* mtcut family (mtcut_dataloader.py:13-90): like attncut with stats from the
  `mtcut/` subdirectory (the 47-feature mq2007 variant).
* bicut family: run.py:61-62 routes bicut through the attncut loader (the lazy
  per-query loader bicut_dataloader.py is deprecated); we do the same.

The synthetic generator replaces the gitignored robust04 pickles (reference
.gitignore:7-9) with a deterministic fixture matching their statistics: ~250
queries, length-300 lists, ~45 relevant docs per query concentrated toward the
top (retrieval-quality-dependent), score curves that decay with rank, and stat
features correlated with relevance so models can actually learn.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np


@dataclasses.dataclass
class RankedListData:
    """Whole-dataset arrays (tiny: <=250 queries), host-side numpy."""

    x_train: np.ndarray  # (N_train, L, F) float32
    y_train: np.ndarray  # (N_train, L) float32 binary relevance
    x_test: np.ndarray   # (N_test, L, F)
    y_test: np.ndarray   # (N_test, L)

    @property
    def seq_len(self) -> int:
        return self.x_train.shape[1]

    @property
    def num_features(self) -> int:
        return self.x_train.shape[2]


def dataset_feature_dim(model_name: str, retrieve_data: str) -> int:
    """Feature width per model family (reference run.py:60, :70, :86).

    Delegates to the single table in TrainConfig.input_size so the two can
    never drift."""
    from rlt_tpu_torch.config import TrainConfig

    return TrainConfig(model_name=model_name,
                       retrieve_data=retrieve_data).input_size


# ---------------------------------------------------------------------------
# pkl ingestion
# ---------------------------------------------------------------------------

def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _relevance_labels(doc_scores: dict, rel_set: set) -> np.ndarray:
    """Binary gt-membership labels in ranked order (attncut_dataloader.py:50,
    bicut_dataloader.py:25)."""
    return np.asarray(
        [1.0 if doc in rel_set else 0.0 for doc in doc_scores.keys()],
        dtype=np.float32,
    )


def _join_split(scores_raw: dict, stats: dict | None, gt: dict):
    """Replicates the per-query join of attncut_dataloader.py:42-57."""
    xs, ys = [], []
    for qid, doc_scores in scores_raw.items():
        scores = np.asarray(list(doc_scores.values()), dtype=np.float32)
        is_rel = _relevance_labels(doc_scores, gt[qid])
        if stats is not None:
            feat = np.column_stack((scores, np.asarray(stats[qid], dtype=np.float32)))
        else:
            feat = scores[:, None]
        xs.append(feat)
        ys.append(is_rel)
    return np.stack(xs).astype(np.float32), np.stack(ys).astype(np.float32)


def load_pkl_dataset(
    base: str,
    retrieve_data: str = "robust04",
    dataset_name: str = "drmm_tks",
    family: str = "attncut",
) -> RankedListData:
    """Load a reference-format pickle dataset.

    family: 'attncut' | 'bicut' (stats from attncut/), 'mtcut' (stats from
    mtcut/), 'choopy' | 'mtchoopy' (scores only).
    """
    db = os.path.join(base, retrieve_data)
    gt = {k: set(v) for k, v in _load_pickle(os.path.join(db, "gt.pkl")).items()}
    train_raw = _load_pickle(os.path.join(db, f"{dataset_name}_train.pkl"))
    test_raw = _load_pickle(os.path.join(db, f"{dataset_name}_test.pkl"))

    stats_dir = {"attncut": "attncut", "bicut": "attncut", "mtcut": "mtcut"}.get(family)
    if stats_dir is not None:
        stats_train = _load_pickle(os.path.join(db, stats_dir, f"{dataset_name}_train.pkl"))
        stats_test = _load_pickle(os.path.join(db, stats_dir, f"{dataset_name}_test.pkl"))
    else:
        stats_train = stats_test = None

    x_train, y_train = _join_split(train_raw, stats_train, gt)
    x_test, y_test = _join_split(test_raw, stats_test, gt)
    return RankedListData(x_train, y_train, x_test, y_test)


def load_bicut_lazy(
    base: str,
    retrieve_data: str = "robust04",
    dataset_name: str = "drmm_tks",
) -> RankedListData:
    """Ingest the reference's per-query bicut layout
    (bicut_dataloader.py:10-29): `<base>/<retrieve_data>/bicut/<ds>_<stage>/`
    holds one pkl per qid with that query's (L, F) feature matrix; labels are
    rederived per query as gt-membership of the ranked doc ids from
    `<ds>_<stage>.pkl` (Rank_Dataset.__getitem__ :21-26).

    The reference streams these lazily through DataLoader workers because its
    bicut features are 231449-dim dense tf-idf; here the result is stacked
    into one device-ready array (the loader exists for layout parity — the
    trainer routes bicut through the attncut family, run.py:61-62).
    """
    db = os.path.join(base, retrieve_data)
    gt = {k: set(v) for k, v in _load_pickle(os.path.join(db, "gt.pkl")).items()}

    def load_stage(stage: str):
        stage_dir = os.path.join(db, "bicut", f"{dataset_name}_{stage}")
        raw = _load_pickle(os.path.join(db, f"{dataset_name}_{stage}.pkl"))
        xs, ys = [], []
        fnames = sorted(f for f in os.listdir(stage_dir) if f.endswith(".pkl"))
        if not fnames:
            raise ValueError(f"no per-query pkl files in {stage_dir}")
        for fname in fnames:
            qid = fname[: -len(".pkl")]  # qids may themselves contain dots
            feat = np.asarray(_load_pickle(os.path.join(stage_dir, fname)),
                              dtype=np.float32)
            xs.append(feat)
            ys.append(_relevance_labels(raw[qid], gt[qid]))
        return np.stack(xs), np.stack(ys)

    x_train, y_train = load_stage("train")
    x_test, y_test = load_stage("test")
    return RankedListData(x_train, y_train, x_test, y_test)


# ---------------------------------------------------------------------------
# Synthetic fixture
# ---------------------------------------------------------------------------

# retrieval_quality calibrated so synthetic oracle F1 matches the reference's
# per-ranker oracle (Baseline/Oracle.ipynb cell 10/13):
#   robust04: BM25 0.4413, DRMM 0.4398, DRMM-TKS 0.8547 (L=300, ~45 rel/query)
#   mq2007:   BM25 0.6169, DRMM-TKS 0.8877           (L=40, ~8 rel/query)
SYNTHETIC_QUALITY = {
    "robust04": {"bm25": 3.2, "drmm": 3.2, "drmm_tks": 19.5},
    "mq2007": {"bm25": 4.0, "drmm": 4.0, "drmm_tks": 13.8},
}
SYNTHETIC_MEAN_RELEVANT = {"robust04": 45.0, "mq2007": 8.0}


def synthetic_quality(dataset_name: str, retrieve_data: str = "robust04") -> float:
    table = SYNTHETIC_QUALITY.get(retrieve_data, SYNTHETIC_QUALITY["robust04"])
    return table.get(dataset_name, table["drmm_tks"])


# The "<dataset>_hard" profile keeps the relevance PLACEMENT of the base
# dataset (so the oracle ceiling is unchanged, ~0.85 F1 for drmm_tks) but
# corrupts and restructures the FEATURES so per-position evidence alone
# cannot reach it: a fraction of relevance evidence is flipped (caps every
# model's ceiling ~7 points under oracle), per-query nuisance gain/offset
# forces list-level normalization, and the informative stat channel rotates
# across three query subtypes (with decoy structure in the others) so
# per-query feature routing — the MMOE gate's job, reference MMOECut.py:30-41
# — carries real signal. Restores the model spread the real robust04 corpus
# shows (hyper_parameter_drmm_tks.conf best-f1 comments: attncut vs mmoecut)
# that the saturating standard profile cannot.
# Calibrated on TPU (scripts/calibrate_hard.py, 3 seeds, conf hparams):
# oracle 0.834, train-fit fixed-k floor 0.744, AttnCut 0.780 — matching the
# real-corpus geometry (reference conf:42 attncut 0.7835, oracle 0.8547).
SYNTHETIC_HARD_PROFILE = dict(
    evidence_flip=0.10,
    nuisance_gain=0.35,
    subtypes=3,
    noise_scale=1.25,
    relevant_spread=0.8,
)


def synthetic_config(retrieve_data: str, dataset_name: str) -> dict:
    """kwargs for synthetic_dataset matching the corpus statistics."""
    hard = dataset_name.endswith("_hard")
    base_name = dataset_name[: -len("_hard")] if hard else dataset_name
    cfg = {
        "retrieval_quality": synthetic_quality(base_name, retrieve_data),
        "mean_relevant": SYNTHETIC_MEAN_RELEVANT.get(retrieve_data, 45.0),
    }
    if hard:
        cfg.update(SYNTHETIC_HARD_PROFILE)
    return cfg

def synthetic_dataset(
    num_queries: int = 250,
    seq_len: int = 300,
    num_features: int = 3,
    retrieval_quality: float = 2.5,
    mean_relevant: float = 45.0,
    train_fraction: float = 0.8,
    seed: int = 0,
    evidence_flip: float = 0.0,
    nuisance_gain: float = 0.0,
    subtypes: int = 0,
    noise_scale: float = 1.0,
    relevant_spread: float = 0.0,
    subtype_polarity: float = 0.0,
    hetero_reliability: float = 0.0,
) -> RankedListData:
    """Deterministic synthetic ranked lists with robust04-like statistics.

    Each query draws ~Poisson(mean_relevant) relevant docs placed with
    probability proportional to exp(-quality * rank / L) — higher quality
    concentrates relevance at the top (DRMM-TKS-like, oracle F1 ~0.85); low
    quality spreads it out (BM25-like, oracle F1 ~0.45). Features: channel 0 is
    a decaying noisy retrieval score; channels 1+ are noisy relevance-correlated
    similarity statistics (standing in for the tf-idf / doc2vec neighbor
    cosine-similarity features of data_prep/document_statics.ipynb cells 44-57).

    Hard-profile knobs (all off by default; see SYNTHETIC_HARD_PROFILE):

    * evidence_flip: fraction of relevant docs whose features carry NO
      relevance evidence, matched by spurious evidence on an equal expected
      number of irrelevant docs. Labels stay true — only the features lie —
      so the oracle ceiling is unchanged while every trained model's ceiling
      drops below it.
    * nuisance_gain: per-query log-normal gain + normal offset applied to
      every feature channel (retrieval-score scale varies by query in real
      corpora); models must normalize per list, which rewards cross-position
      context over pointwise reads.
    * subtypes: number of query subtypes. The relevance evidence in the stat
      channels lives ONLY in channel 1 + (subtype % (F-1)); the other stat
      channels carry a rank-correlated decoy of query-varying gain, and the
      score channel's decay rate varies by subtype (a list-shape cue to the
      subtype). Per-query routing over channels is exactly what the MMOE
      gate learns (reference MMOECut.py:30-41).
    * noise_scale: multiplies every additive noise sigma.
    * subtype_polarity: with subtypes > 0, rotates the SIGN of the
      informative channel's evidence across subtypes — channel
      1 + (subtype % (F-1)) carries +w evidence when
      (subtype // (F-1)) is even and -w (scaled by this knob) when odd.
      With 4 subtypes and 2 stat channels every channel carries both
      polarities across queries, so an unconditional pointwise read of any
      channel is uninformative: a model must infer the subtype (the score
      channel's decay rate is the cue) and condition its feature processing
      on it — per-query conditional routing, the mechanism MMOE's per-query
      gates implement natively (reference MMOECut.py:30-41, :95-102).
    * relevant_spread: widens the PER-QUERY relevant-count distribution —
      each query's Poisson mean is mean_relevant * Uniform(1-s, 1+s). The
      oracle (which adapts k per query) keeps its ceiling, but any fixed or
      rank-only cut degrades: a model must read the list's evidence to find
      where ITS relevance stops, which is the actual truncation task.
    * hetero_reliability: per-query HETEROSCEDASTIC feature reliability —
      the round-3 MMOE-margin attribution, now a testable axis (VERDICT r3
      ask #1). Each query draws a reliability share over the F-1 stat
      channels from Dirichlet(alpha) with alpha = 1.5*(1-h) (h→1 means most
      queries trust ONE channel); channel c's evidence weight scales with
      its share while its noise sigma scales with (1 - share), keeping the
      TOTAL evidence budget constant per query. A per-query router that
      reads each channel's noise level (estimable from the list itself —
      the cue) recovers full SNR from the reliable channel; a monolithic
      encoder that pools channels unconditionally averages low-noise signal
      with high-noise noise. This is precisely the per-query gating
      mechanism of reference models/MMOECut.py:94-102. Overrides the
      subtypes channel-weight scheme when both are set.
    """
    rng = np.random.default_rng(seed)
    n = num_queries
    ranks = np.arange(seq_len, dtype=np.float32)

    # relevance placement
    place_logits = -retrieval_quality * ranks / seq_len
    place_p = np.exp(place_logits)
    y = np.zeros((n, seq_len), dtype=np.float32)
    if relevant_spread > 0.0:
        lo, hi = 1.0 - relevant_spread, 1.0 + relevant_spread
        query_means = mean_relevant * rng.uniform(lo, hi, size=n)
    else:
        query_means = np.full(n, mean_relevant)
    for i in range(n):
        k = max(1, int(rng.poisson(query_means[i])))
        k = min(k, seq_len)
        probs = place_p / place_p.sum()
        idx = rng.choice(seq_len, size=k, replace=False, p=probs)
        y[i, idx] = 1.0

    # observed relevance: what the FEATURES reflect. evidence_flip hides a
    # fraction of true relevance and fabricates a matched amount, capping the
    # achievable test F1 strictly below the (true-y) oracle.
    y_obs = y
    if evidence_flip > 0.0:
        rel = y > 0.5
        hide = (rng.random(y.shape) < evidence_flip) & rel
        irr_rate = evidence_flip * mean_relevant / max(seq_len - mean_relevant, 1.0)
        fabricate = (rng.random(y.shape) < irr_rate) & ~rel
        y_obs = np.where(hide, 0.0, np.where(fabricate, 1.0, y))

    # per-query subtype: rotates which stat channel is informative and skews
    # the score decay (so the list shape itself hints at the subtype)
    subtype = rng.integers(0, subtypes, size=n) if subtypes > 0 else np.zeros(n, np.int64)
    decay = np.full(n, 3.0, np.float32)
    if subtypes > 0:
        decay = (3.0 * (1.0 + 0.35 * (subtype - (subtypes - 1) / 2.0))).astype(np.float32)

    # retrieval score: decays with rank, relevant docs get a bump, plus noise
    base_score = np.exp(-decay[:, None] * ranks[None, :] / seq_len)
    # stat channels load-bearing under the routing axes (subtype / hetero)
    score_bump = 0.10 if (subtypes > 0 or hetero_reliability > 0.0) else 0.25
    score = (base_score + score_bump * y_obs
             + 0.08 * noise_scale * rng.standard_normal((n, seq_len)))
    score = score.astype(np.float32)

    # per-query reliability shares over the stat channels (hetero axis)
    rel_share = None
    if hetero_reliability > 0.0 and num_features > 1:
        n_stat = num_features - 1
        alpha = max(0.15, 1.5 * (1.0 - hetero_reliability))
        rel_share = rng.dirichlet(np.full(n_stat, alpha), size=n)  # (n, F-1)

    feats = [score]
    for c in range(1, num_features):
        if rel_share is not None:
            # evidence budget 0.6*(F-1) split by share; noise sigma grows as
            # the channel's share shrinks — the unreliable channel is both
            # weak-evidence and loud, and its loudness is visible in the list
            share = rel_share[:, c - 1][:, None].astype(np.float32)  # (n,1)
            w = 0.6 * (num_features - 1) * share
            sigma = 0.15 * noise_scale * (0.25 + 1.75 * (1.0 - share))
            stat = w * y_obs + sigma * rng.standard_normal((n, seq_len))
            stat = (0.5 * stat + 0.25 * np.roll(stat, 1, axis=1)
                    + 0.25 * np.roll(stat, -1, axis=1))
            feats.append(stat.astype(np.float32))
            continue
        if subtypes > 0:
            informative = (1 + (subtype % (num_features - 1))) == c  # (n,)
            # polarity rotation: odd subtype//(F-1) groups carry flipped
            # evidence in their informative channel (see docstring)
            odd_group = (subtype // max(num_features - 1, 1)) % 2 == 1
            sign = np.where(odd_group, 1.0 - 2.0 * subtype_polarity, 1.0)
            w = (np.where(informative, 0.6, 0.0) * sign)[:, None].astype(np.float32)
            # decoy: rank-correlated ramp of query-varying gain in the
            # uninformative channels — pointwise it mimics evidence
            decoy_gain = np.where(informative, 0.0,
                                  0.3 * rng.standard_normal(n))[:, None]
            decoy = decoy_gain * np.exp(-2.0 * ranks[None, :] / seq_len)
        else:
            w = 0.5 / c  # later channels are weaker signals
            decoy = 0.0
        stat = (w * y_obs + decoy
                + 0.15 * noise_scale * rng.standard_normal((n, seq_len)))
        # neighbor-smoothed, like the reference's neighbor cosine sims
        stat = 0.5 * stat + 0.25 * np.roll(stat, 1, axis=1) + 0.25 * np.roll(stat, -1, axis=1)
        feats.append(stat.astype(np.float32))
    x = np.stack(feats, axis=-1)  # (N, L, F)

    if nuisance_gain > 0.0:
        gain = np.exp(nuisance_gain * rng.standard_normal((n, 1, num_features)))
        offset = nuisance_gain * rng.standard_normal((n, 1, num_features))
        x = (x * gain + offset).astype(np.float32)

    n_train = int(round(train_fraction * n))
    perm = rng.permutation(n)
    tr, te = perm[:n_train], perm[n_train:]
    return RankedListData(x[tr], y[tr], x[te], y[te])
