"""Device-resident batching: the dataset on the device and the padded,
shuffled batch plan of each epoch.

The counterpart of the JAX package's `data/batching.py`. The corpora are
small (~250 queries x 300 x F floats), so each split lives on the device
as one tensor and a batch is an index gather. An epoch's plan is one
permutation padded with index 0 to whole batches of the static size, with a
float `valid` mask of the real rows. A plan may also be handed in from
outside (`DeviceDataset.plan`), so that a test can replay the JAX
package's `jax.random.permutation`, which torch cannot reproduce.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def num_batches(n: int, batch_size: int) -> int:
    return -(-n // batch_size)


def epoch_permutation(generator: torch.Generator, n: int, batch_size: int):
    """(idx, valid): idx (num_batches, batch_size) int64 gather indices, the
    padding rows repeating index 0; valid the same shape in float32, 1 on
    real rows. Drawn on the generator's device."""
    nb = num_batches(n, batch_size)
    device = generator.device
    perm = torch.randperm(n, generator=generator, device=device)
    pad = nb * batch_size - n
    idx = torch.cat([perm, torch.zeros(pad, dtype=perm.dtype, device=device)])
    valid = torch.cat([torch.ones(n, device=device), torch.zeros(pad, device=device)])
    return idx.reshape(nb, batch_size), valid.reshape(nb, batch_size)


@dataclasses.dataclass
class DeviceDataset:
    """Train and test splits as tensors on one device, and the batch size."""

    x_train: torch.Tensor
    y_train: torch.Tensor
    x_test: torch.Tensor
    y_test: torch.Tensor
    batch_size: int

    @classmethod
    def from_host(cls, data, batch_size: int, device) -> "DeviceDataset":
        """A RankedListData (numpy arrays) onto `device`."""
        put = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(device)  # noqa: E731
        return cls(put(data.x_train), put(data.y_train), put(data.x_test),
                   put(data.y_test), batch_size)

    @property
    def n_train(self) -> int:
        return self.x_train.shape[0]

    @property
    def n_test(self) -> int:
        return self.x_test.shape[0]

    @property
    def train_batches(self) -> int:
        return num_batches(self.n_train, self.batch_size)

    @property
    def test_batches(self) -> int:
        return num_batches(self.n_test, self.batch_size)

    def plan(self, generator: torch.Generator, split: str = "train", idx=None,
             valid=None):
        """An epoch's batch plan of `split`: drawn from `generator`, or the
        given (idx, valid), checked and moved to the data's device."""
        n = self.n_train if split == "train" else self.n_test
        if idx is None:
            return epoch_permutation(generator, n, self.batch_size)
        idx = torch.as_tensor(np.array(idx), dtype=torch.int64).to(self.x_train.device)
        valid = torch.as_tensor(np.array(valid), dtype=torch.float32).to(idx.device)
        want = (num_batches(n, self.batch_size), self.batch_size)
        if tuple(idx.shape) != want or tuple(valid.shape) != want:
            raise ValueError(f"a {split} plan must be {want}, got {tuple(idx.shape)} "
                             f"and {tuple(valid.shape)}")
        return idx, valid
