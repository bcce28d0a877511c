"""Raw-text front-end: document cleaning and tokenization.

A copy of the JAX package's `data/text.py` (host code there too), kept in
the port so that it never imports that package, nor sklearn: `STOPWORDS`
is a literal here, the 318 words of sklearn's `ENGLISH_STOP_WORDS` (the
Glasgow IR list) plus the words gensim's list adds, the same frozenset the
JAX package builds from sklearn (tests/test_torch_data_prep.py holds the
two equal).

It mirrors data_prep/document_statics.ipynb cells 4-6
(`get_corpus_element`): raw document text -> cleaned token lists ready for
`features.build_stat_features` / `doc2vec.train_doc2vec`.

Cleaning semantics (cell 5, reproduced step for step):

1. character substitutions, in the reference's order — quotes, slashes,
   newlines/tabs and dashes become spaces; periods are DELETED (so "U.S"
   joins to "us"); the TREC entities ``&hyph;`` / ``&blank;`` become spaces;
2. one regex pass replaces remaining punctuation AND digits with spaces;
3. lowercase, whitespace split, drop stopwords and single-character tokens;
4. drop tokens that appear only once WITHIN the document (the reference's
   per-document hapax filter — frequency is counted per document, not over
   the corpus).
"""

from __future__ import annotations

import re

# sklearn's ENGLISH_STOP_WORDS, word for word
_GLASGOW = frozenset("""
a about above across after afterwards again against all almost alone
along already also although always am among amongst amoungst amount an
and another any anyhow anyone anything anyway anywhere are around as at
back be became because become becomes becoming been before beforehand
behind being below beside besides between beyond bill both bottom but by
call can cannot cant co con could couldnt cry de describe detail do done
down due during each eg eight either eleven else elsewhere empty enough
etc even ever every everyone everything everywhere except few fifteen
fifty fill find fire first five for former formerly forty found four
from front full further get give go had has hasnt have he hence her here
hereafter hereby herein hereupon hers herself him himself his how
however hundred i ie if in inc indeed interest into is it its itself
keep last latter latterly least less ltd made many may me meanwhile
might mill mine more moreover most mostly move much must my myself name
namely neither never nevertheless next nine no nobody none noone nor not
nothing now nowhere of off often on once one only onto or other others
otherwise our ours ourselves out over own part per perhaps please put
rather re same see seem seemed seeming seems serious several she should
show side since sincere six sixty so some somehow someone something
sometime sometimes somewhere still such system take ten than that the
their them themselves then thence there thereafter thereby therefore
therein thereupon these they thick thin third this those though three
through throughout thru thus to together too top toward towards twelve
twenty two un under until up upon us very via was we well were what
whatever when whence whenever where whereafter whereas whereby wherein
whereupon wherever whether which while whither who whoever whole whom
whose why will with within without would yet you your yours yourself
yourselves
""".split())

# words gensim.parsing.preprocessing.STOPWORDS adds on top of the Glasgow
# list sklearn ships verbatim
_GENSIM_EXTRA = frozenset("""
computer did didn does doesn doing don just kg km make quite really
regarding say unless used using various
""".split())

STOPWORDS = _GLASGOW | _GENSIM_EXTRA

# substitutions applied before the regex pass, in the reference's order
# (cell 5): all become a space except the period, which is deleted
_SPACE_CHARS = ('"', "/", "\\", "'", "\n", "\r", "\t", "-")
_ENTITY_CHARS = ("&hyph;", "&blank;")
_PUNCT_DIGITS = re.compile(r"[,?;*!%^&_+():\[\]{}`~@#$=+\\|/<>.'\"\d]")


def clean_text(text: str, stopwords: frozenset = STOPWORDS,
               drop_hapax: bool = True) -> list[str]:
    """Reference get_corpus_element (document_statics.ipynb cell 5):
    raw text -> cleaned token list. ``drop_hapax=False`` skips step 4 for
    callers that want every kept token (e.g. short queries)."""
    for ch in _SPACE_CHARS:
        text = text.replace(ch, " ")
    text = text.replace(".", "")
    for ch in _ENTITY_CHARS:
        text = text.replace(ch, " ")
    text = _PUNCT_DIGITS.sub(" ", text.strip().lower())
    tokens = [w for w in text.split() if w not in stopwords and len(w) > 1]
    if not drop_hapax:
        return tokens
    freq: dict[str, int] = {}
    for t in tokens:
        freq[t] = freq.get(t, 0) + 1
    return [t for t in tokens if freq[t] > 1]


def corpus_from_docset(docset: dict, fields=("title", "abstractText"),
                       **clean_kwargs) -> dict[str, list[str]]:
    """Cell 6: docset {doc_id: {"title": ..., "abstractText": ...}} (or
    {doc_id: raw_text}) -> {doc_id: cleaned token list}. Field values are
    concatenated in order; missing fields contribute nothing."""
    out = {}
    for doc_id, entry in docset.items():
        if isinstance(entry, str):
            text = entry
        else:
            text = " ".join(str(entry.get(f, "")) for f in fields)
        out[doc_id] = clean_text(text, **clean_kwargs)
    return out


def tokens_for_ranked(ranked: dict[str, dict[str, float]],
                      doc_tokens: dict[str, list[str]],
                      ) -> dict[str, list[list[str]]]:
    """Align a per-document token table with each query's ranked doc order —
    the shape `features.build_stat_features` consumes. Documents absent from
    the table get an empty token list (zero-length doc; its stat features
    are zeros and its tf-idf vector is empty, matching a document the
    reference's docset simply lacked)."""
    return {qid: [doc_tokens.get(d, []) for d in docs]
            for qid, docs in ranked.items()}
