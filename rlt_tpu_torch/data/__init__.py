"""Data substrate of the port, the JAX package's names: pkl ingestion and
the synthetic ranked-list generator (numpy), the offline feature pipeline
(numpy text cleaning and features, doc2vec on the card) and the
device-resident batching. Dataset preparation is `data/prep.py` (`python -m
rlt_tpu_torch.data.prep`)."""

from rlt_tpu_torch.data.batching import (  # noqa: F401
    DeviceDataset,
    epoch_permutation,
    num_batches,
)
from rlt_tpu_torch.data.datasets import (  # noqa: F401
    RankedListData,
    dataset_feature_dim,
    load_pkl_dataset,
    synthetic_config,
    synthetic_dataset,
    synthetic_quality,
)
from rlt_tpu_torch.data.doc2vec import (  # noqa: F401
    Doc2Vec,
    doc2vec_embeddings_per_query,
    train_doc2vec,
)
from rlt_tpu_torch.data.features import (  # noqa: F401
    doc_stats,
    neighbor_cosine_similarity,
    tfidf_vectors,
)
from rlt_tpu_torch.data.text import (  # noqa: F401
    STOPWORDS,
    clean_text,
    corpus_from_docset,
    tokens_for_ranked,
)
