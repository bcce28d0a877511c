"""Data substrate of the port: the numpy-only dataset constructors and the
device-resident batching."""

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
