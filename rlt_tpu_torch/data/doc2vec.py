"""doc2vec (PV-DBOW) on the card, for the offline feature pipeline.

The counterpart of the JAX package's `data/doc2vec.py`, which replaces the
reference's gensim ``Doc2Vec(vector_size=200, min_count=2, epochs=40)``
(data_prep/document_statics.ipynb cells 25-29) with a jitted PV-DBOW: the
same vocabulary with ``min_count`` pruning, the same unigram^0.75
negative-sampling CDF, the same objective (log σ(d·w⁺) + Σ log σ(−d·w⁻),
SUMMED over a minibatch of (doc, word) pairs, so that one pass at lr α
steps each pair as gensim's per-sample SGD at alpha=α does), plain SGD
with the learning rate decaying linearly over the epochs, and the same
host permutation of the pairs each epoch (numpy's generator from the
seed). Its defaults are the JAX package's: vector_size 200, min_count 2,
40 epochs, batches of 256 pairs, 5 negatives, lr 0.025.

It runs on the CUDA card unless the caller passes ``device="cpu"``, and
raises with no card and no CPU request. The random bits are torch's, from
one explicit `torch.Generator` on the device: the initial vectors, then
each epoch's uniforms, drawn for the whole epoch at once and turned into
negative word ids by inverse-CDF sampling (`torch.searchsorted`), as the
JAX epoch does with `jnp.searchsorted`. The JAX package draws with its own
generator, so the two agree in distribution, not bit for bit; fed the same
pairs at ``negatives=0`` their epochs agree to rounding
(tests/test_torch_doc2vec.py).

An epoch (`epoch`) is a loop of minibatch SGD steps over a device table that
stacks the document and word vectors. A step adds -lr times each of its
gradient rows into the table's rows in place, in an order that is fixed, so
that an epoch repeats bit for bit with one seed: on the card by
`index_put_(accumulate=True)`, which on a CUDA tensor sorts the indices and
adds the rows of each index in that order, and on the CPU by `index_add_`,
which adds them one index after another. An atomic scatter-add would sum
repeated documents and words in whatever order the threads arrive, as
`index_add_` does on a CUDA tensor and `index_put_(accumulate=True)` on a
CPU float tensor with more than one thread. Only the rows a step touches
are read and written.
Plain PyTorch ops: the JAX module has no Pallas kernel.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch

from rlt_tpu_torch.utils.platform import resolve_device

NEG_SAMPLING_POWER = 0.75  # word2vec/gensim unigram^0.75 negative table
INFER_CHUNK = 32  # documents inferred at once by `Doc2Vec.infer_vectors`


def build_doc2vec_vocab(
    token_lists: list[list[str]], min_count: int = 2
) -> dict[str, int]:
    """Vocabulary with gensim's ``min_count`` pruning (default 2, as the
    reference's Doc2Vec(min_count=2))."""
    counts: dict[str, int] = {}
    for toks in token_lists:
        for tok in toks:
            counts[tok] = counts.get(tok, 0) + 1
    vocab: dict[str, int] = {}
    for toks in token_lists:
        for tok in toks:
            if counts[tok] >= min_count and tok not in vocab:
                vocab[tok] = len(vocab)
    return vocab


def _corpus_pairs(
    token_lists: list[list[str]], vocab: dict[str, int]
) -> tuple[np.ndarray, np.ndarray]:
    """(doc_id, word_id) training pairs + unigram counts for the neg table."""
    docs, words = [], []
    counts = np.zeros((len(vocab),), dtype=np.float64)
    for d, toks in enumerate(token_lists):
        for tok in toks:
            w = vocab.get(tok)
            if w is not None:
                docs.append(d)
                words.append(w)
                counts[w] += 1.0
    pairs = np.stack(
        [np.asarray(docs, dtype=np.int32), np.asarray(words, dtype=np.int32)], axis=1
    )
    return pairs, counts


def negative_cdf(counts: np.ndarray) -> np.ndarray:
    """The cumulative unigram^0.75 distribution, float32, as the JAX package
    builds it."""
    probs = counts**NEG_SAMPLING_POWER
    return np.asarray(np.cumsum(probs / probs.sum()), dtype=np.float32)


def draw_negatives(neg_cdf: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sampling: the word id of each uniform, int64 (the first
    i with u <= cdf[i]). A uniform above the float32 cdf's last entry,
    which may fall short of 1, takes the last word, as JAX's gather clamps
    the index `jnp.searchsorted` gives it."""
    return torch.searchsorted(neg_cdf, uniforms).clamp_(max=neg_cdf.shape[0] - 1)


def _pv_dbow_grads(d: torch.Tensor, words: torch.Tensor, sign: torch.Tensor):
    """The summed loss's gradient at one step's rows: d (B, dim) document
    vectors, words (B, 1 + n, dim) the positive word's vector then the n
    negatives'. With scores s = d·w, the loss -log σ(s⁺) - Σ log σ(-s⁻) has
    ds⁺ = -σ(-s⁺) and ds⁻ = σ(s⁻), i.e. sign σ(sign s) with sign (-1, 1,
    ..., 1). Returns (dd (B, dim), dwords (B, 1 + n, dim))."""
    scores = torch.bmm(words, d[:, :, None])[..., 0]  # (B, 1 + n)
    g = sign * torch.sigmoid(sign * scores)
    dd = torch.bmm(g[:, None, :], words)[:, 0]
    return dd, g[:, :, None] * d[:, None, :]


def epoch(doc_emb: torch.Tensor, word_emb: torch.Tensor, batched_pairs: torch.Tensor,
          neg_cdf: torch.Tensor, lr: float, generator: torch.Generator,
          negatives: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One epoch of PV-DBOW: minibatch SGD steps over `batched_pairs`
    (num_batches, batch, 2) (doc id, word id) pairs, in order, each pair
    with `negatives` word ids drawn from this epoch's uniforms (from
    `generator`, drawn at once). Returns the new (doc_emb, word_emb); the
    inputs are left as they were."""
    num_batches, batch = batched_pairs.shape[:2]
    uniforms = torch.rand((num_batches, batch, negatives), generator=generator,
                          device=doc_emb.device)
    neg = draw_negatives(neg_cdf.to(doc_emb.device), uniforms)
    return epoch_steps(doc_emb, word_emb, batched_pairs, neg, lr)


def epoch_steps(doc_emb: torch.Tensor, word_emb: torch.Tensor,
                batched_pairs: torch.Tensor, neg: torch.Tensor,
                lr: float) -> tuple[torch.Tensor, torch.Tensor]:
    """`epoch`'s SGD steps on given negatives: `neg` (num_batches, batch, n)
    word ids, the n negatives of each pair. Each step subtracts lr times the
    gradient of the summed loss from the rows it touched, in place in a
    copy of the tables. Returns the new (doc_emb, word_emb)."""
    num_docs = doc_emb.shape[0]
    device = doc_emb.device
    pairs = batched_pairs.to(device=device, dtype=torch.int64)
    # every step's rows of one table: its document, its word, its negatives
    index = torch.cat([pairs[..., :1], num_docs + pairs[..., 1:],
                       num_docs + neg.to(device=device, dtype=torch.int64)],
                      dim=-1)  # (num_batches, batch, 2 + n)
    sign = torch.ones(index.shape[-1] - 1, device=device)
    sign[0] = -1.0
    table = torch.cat([doc_emb, word_emb])
    for step in range(index.shape[0]):
        rows = index[step]
        d = table[rows[:, 0]]
        words = table[rows[:, 1:]]
        dd, dwords = _pv_dbow_grads(d, words, sign)
        update = torch.cat([dd[:, None], dwords], dim=1).mul_(-lr).reshape(-1, table.shape[1])
        if table.is_cuda:
            table.index_put_((rows.reshape(-1),), update, accumulate=True)
        else:
            table.index_add_(0, rows.reshape(-1), update)
    return table[:num_docs], table[num_docs:]


def _doc_generator(seed: int, word_ids: np.ndarray, device) -> torch.Generator:
    """A document's own generator, from the model's seed and the document's
    token ids (as the JAX package folds their crc32 into its key), so that
    a document infers the same vector alone or in a batch."""
    crc = zlib.crc32(word_ids.tobytes()) & 0x7FFFFFFF
    return torch.Generator(device=device).manual_seed(((seed + 1) << 31) + crc)


@dataclass
class Doc2Vec:
    """Trained PV-DBOW model. ``docvecs[i]`` is document i's vector; use
    `infer_vector` for held-out token lists (or to mirror the reference,
    which re-infers even for in-corpus documents). `device` runs the
    inference."""

    vocab: dict[str, int]
    docvecs: np.ndarray  # (num_docs, dim)
    wordvecs: np.ndarray  # (vocab, dim)
    neg_cdf: np.ndarray  # (vocab,) cumulative unigram^0.75 distribution
    lr: float
    negatives: int
    seed: int
    device: str = "cuda"

    def _encode(self, tokens: list[str], max_len: int):
        ids = [self.vocab[t] for t in tokens if t in self.vocab][:max_len]
        word_ids = np.zeros((max_len,), dtype=np.int32)
        valid = np.zeros((max_len,), dtype=np.float32)
        word_ids[: len(ids)] = ids
        valid[: len(ids)] = 1.0
        return word_ids, valid

    def _infer_chunk(self, encoded, steps: int, max_len: int) -> torch.Tensor:
        device = resolve_device(self.device)
        dim = self.wordvecs.shape[1]
        inits, draws = [], []
        for word_ids, _ in encoded:
            g = _doc_generator(self.seed, word_ids, device)
            inits.append(torch.empty(dim, device=device).uniform_(
                -0.5 / dim, 0.5 / dim, generator=g))
            draws.append(torch.rand((steps, max_len, self.negatives), generator=g,
                                    device=device))
        # positions past the longest document carry no valid token
        length = max(1, max(int(v.sum()) for _, v in encoded))
        word_emb = torch.from_numpy(self.wordvecs).to(device)
        cdf = torch.from_numpy(self.neg_cdf).to(device)
        ids = torch.from_numpy(np.stack([w[:length] for w, _ in encoded])).to(device)
        valid = torch.from_numpy(np.stack([v[:length] for _, v in encoded])).to(device)
        uniforms = torch.stack(draws)[:, :, :length].contiguous()  # (n, steps, T, k)
        neg = draw_negatives(cdf, uniforms)
        wp = word_emb[ids.long()]  # (n, T, dim)
        vec = torch.stack(inits)
        for i in range(steps):
            wn = word_emb[neg[:, i]]  # (n, T, k, dim)
            pos = torch.einsum("ntd,nd->nt", wp, vec)
            negs = torch.einsum("ntkd,nd->ntk", wn, vec)
            gpos = -torch.sigmoid(-pos) * valid
            gneg = torch.sigmoid(negs) * valid[..., None]
            grad = (torch.einsum("nt,ntd->nd", gpos, wp)
                    + torch.einsum("ntk,ntkd->nd", gneg, wn))
            vec = vec - self.lr * (1.0 - i / steps) * grad
        return vec

    def infer_vectors(
        self, token_lists: list[list[str]], steps: int = 40, max_len: int = 512
    ) -> np.ndarray:
        """Batched ``infer_vector`` (gensim's): the word vectors frozen, each
        document fits one fresh vector by `steps` gradient passes over its
        tokens (the first `max_len` in the vocabulary) with lr decaying
        linearly from the model's. Each document draws its init and
        negatives from its own generator (derived from its token ids), so
        documents are independent yet deterministic, alone or batched."""
        encoded = [self._encode(toks, max_len) for toks in token_lists]
        vecs = [self._infer_chunk(encoded[i:i + INFER_CHUNK], steps, max_len)
                for i in range(0, len(encoded), INFER_CHUNK)]
        return torch.cat(vecs).cpu().numpy()

    def infer_vector(
        self, tokens: list[str], steps: int = 40, max_len: int = 512
    ) -> np.ndarray:
        return self.infer_vectors([tokens], steps=steps, max_len=max_len)[0]


def corpus_batches(pairs: np.ndarray, batch_size: int, rng: np.random.Generator):
    """One epoch's (num_batches, batch, 2) pairs: a permutation from `rng`,
    cut to whole batches (the JAX package's host permutation)."""
    num_batches = pairs.shape[0] // batch_size
    perm = rng.permutation(pairs.shape[0])[: num_batches * batch_size]
    return pairs[perm].reshape(num_batches, batch_size, 2)


def train_doc2vec(
    token_lists: list[list[str]],
    vector_size: int = 200,
    min_count: int = 2,
    epochs: int = 40,
    lr: float = 0.025,
    negatives: int = 5,
    batch_size: int = 256,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> Doc2Vec:
    """Train PV-DBOW over the corpus on `device` (the card unless "cpu").
    Defaults mirror the reference's Doc2Vec(vector_size=200, min_count=2,
    epochs=40). The learning rate decays linearly over epochs (gensim
    alpha -> min_alpha); each epoch re-permutes the pair list on the host
    and runs its steps on the device."""
    device = resolve_device(device)
    vocab = build_doc2vec_vocab(token_lists, min_count=min_count)
    if not vocab:
        raise ValueError("empty vocabulary: every token is below min_count")
    pairs, counts = _corpus_pairs(token_lists, vocab)
    if pairs.shape[0] == 0:
        raise ValueError("no training pairs after min_count pruning")
    neg_cdf = negative_cdf(counts)
    cdf = torch.from_numpy(neg_cdf).to(device)

    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    dim = vector_size
    doc_emb = torch.empty(len(token_lists), dim, device=device).uniform_(
        -0.5 / dim, 0.5 / dim, generator=generator)
    word_emb = torch.empty(len(vocab), dim, device=device).uniform_(
        -0.5 / dim, 0.5 / dim, generator=generator)

    batch_size = min(batch_size, pairs.shape[0])
    for e in range(epochs):
        batched = torch.from_numpy(corpus_batches(pairs, batch_size, rng))
        epoch_lr = lr * (1.0 - e / max(epochs, 1))
        doc_emb, word_emb = epoch(doc_emb, word_emb, batched, cdf, epoch_lr, generator,
                                  negatives)

    return Doc2Vec(
        vocab=vocab,
        docvecs=doc_emb.cpu().numpy(),
        wordvecs=word_emb.cpu().numpy(),
        neg_cdf=neg_cdf,
        lr=lr,
        negatives=negatives,
        seed=seed,
        device=device.type,
    )


def doc2vec_embeddings_per_query(
    model: Doc2Vec,
    token_lists_per_query: dict[str, list[list[str]]],
    doc_index: dict[str, dict[int, int]] | None = None,
    infer: bool = False,
) -> dict[str, np.ndarray]:
    """Per-query (L, dim) embedding matrices for `build_stat_features`.

    With ``infer=True`` every document is re-inferred (the reference's exact
    procedure — it calls infer_vector even for training documents, ipynb
    cell 13512); otherwise the trained docvecs are looked up via
    ``doc_index[qid][position] -> corpus row``, or positionally when the
    corpus was built by concatenating the queries' lists in dict order.
    """
    out: dict[str, np.ndarray] = {}
    if infer:
        for qid, toks in token_lists_per_query.items():
            out[qid] = model.infer_vectors(toks)
        return out
    if doc_index is not None:
        for qid, toks in token_lists_per_query.items():
            rows = [doc_index[qid][i] for i in range(len(toks))]
            out[qid] = model.docvecs[rows]
        return out
    total = sum(len(toks) for toks in token_lists_per_query.values())
    if total != model.docvecs.shape[0]:
        raise ValueError(
            f"positional lookup needs the corpus to be exactly the queries' "
            f"lists concatenated in dict order: {total} documents requested "
            f"vs {model.docvecs.shape[0]} trained docvecs; pass doc_index= "
            f"or infer=True instead"
        )
    offset = 0
    for qid, toks in token_lists_per_query.items():
        out[qid] = model.docvecs[offset : offset + len(toks)]
        offset += len(toks)
    return out
