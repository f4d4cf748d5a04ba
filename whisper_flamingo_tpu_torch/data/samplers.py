"""Length-aware batch samplers (framework-agnostic index batching).

Copy of ``whisper_flamingo_tpu/data/samplers.py``: ``SortedBatchSampler``
and ``LengthBatchSampler`` (the reference's ESPnet-derived samplers),
``ShuffledBatchSampler`` (batches shuffled per epoch from ``seed +
epoch``) and ``DistributedBatchSampler`` (whole batches dealt round-robin
to replicas), so the same lengths give the same batch orders.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class SortedBatchSampler:
    """Sort all utterances by length, split into evenly-sized batches.

    Parity: reference utils_batch_samplers.py:6-90.
    """

    def __init__(
        self,
        batch_size: int,
        shapes: Sequence[int],
        sort_in_batch: str = "descending",
        sort_batch: str = "ascending",
        drop_last: bool = False,
        seed: int = 0,
    ):
        assert batch_size > 0
        self.batch_size = batch_size
        if sort_in_batch == "descending":
            keys = sorted(range(len(shapes)), key=lambda k: -shapes[k])
        elif sort_in_batch == "ascending":
            keys = sorted(range(len(shapes)), key=lambda k: shapes[k])
        else:
            raise ValueError(f"sort_in_batch must be ascending or descending: {sort_in_batch}")
        if len(keys) == 0:
            raise RuntimeError("0 lines found")

        N = max(len(keys) // batch_size, 1)
        if not drop_last:
            self.batch_list = [
                keys[i * len(keys) // N : (i + 1) * len(keys) // N] for i in range(N)
            ]
        else:
            self.batch_list = [keys[i * batch_size : (i + 1) * batch_size] for i in range(N)]

        if sort_in_batch != sort_batch:
            if sort_batch not in ("ascending", "descending"):
                raise ValueError(f"sort_batch must be ascending or descending: {sort_batch}")
            self.batch_list.reverse()
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.batch_list)

    def __iter__(self) -> Iterator[List[int]]:
        return iter(self.batch_list)


class LengthBatchSampler:
    """ESPnet token-bin batching: batch while ``bs * max_len <= batch_bins``.

    Parity: reference utils_batch_samplers.py:93-210.
    """

    def __init__(
        self,
        batch_bins: int,
        shapes: Sequence[int],
        min_batch_size: int = 1,
        sort_in_batch: str = "descending",
        sort_batch: str = "ascending",
        drop_last: bool = False,
        padding: bool = True,
    ):
        assert batch_bins > 0
        if sort_in_batch not in ("descending", "ascending"):
            raise ValueError(f"sort_in_batch must be ascending or descending: {sort_in_batch}")

        keys = sorted(range(len(shapes)), key=lambda k: shapes[k])
        if len(keys) == 0:
            raise RuntimeError("0 lines found")

        batch_sizes = []
        current_batch_keys: List[int] = []
        for key in keys:
            current_batch_keys.append(key)
            if padding:
                max_length = shapes[key]  # ascending scan: current is max
                bins = (len(current_batch_keys)) * max_length
            else:
                bins = sum(shapes[k] for k in current_batch_keys)
            if bins > batch_bins and len(current_batch_keys) >= min_batch_size:
                batch_sizes.append(len(current_batch_keys))
                current_batch_keys = []
        else:
            if len(current_batch_keys) != 0 and (
                not drop_last or len(batch_sizes) == 0
            ):
                batch_sizes.append(len(current_batch_keys))

        if len(batch_sizes) == 0:
            batch_sizes = [len(keys)]

        # redistribute a too-small trailing batch (reference :151-154)
        if len(batch_sizes) > 1 and batch_sizes[-1] < min_batch_size:
            for i in range(batch_sizes.pop(-1)):
                batch_sizes[-(i % len(batch_sizes)) - 1] += 1

        self.batch_list = []
        start = 0
        for bs in batch_sizes:
            batch = keys[start : start + bs]
            if sort_in_batch == "descending":
                batch = list(reversed(batch))
            self.batch_list.append(batch)
            start += bs

        if sort_batch == "descending":
            self.batch_list.reverse()
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.batch_list)

    def __iter__(self) -> Iterator[List[int]]:
        return iter(self.batch_list)


class ShuffledBatchSampler:
    """Shuffle batches (not samples) each epoch, keeping length grouping."""

    def __init__(self, base, seed: int = 0):
        self.base = base
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.base)

    def __iter__(self):
        batches = list(iter(self.base))
        order = np.random.default_rng(self.seed + self._epoch).permutation(len(batches))
        return iter([batches[i] for i in order])


class DistributedBatchSampler:
    """Deal whole batches round-robin to ``num_replicas`` hosts.

    Replaces the reference's sample-level ``DistributedSamplerWrapper``
    (`utils.py:673-755`); with pjit data parallelism each host feeds its
    shard of the global batch, so slicing batches is the natural unit.
    """

    def __init__(self, base, num_replicas: int, rank: int):
        assert 0 <= rank < num_replicas
        self.base = base
        self.num_replicas = num_replicas
        self.rank = rank

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.base) // self.num_replicas

    def __iter__(self):
        batches = list(iter(self.base))
        usable = len(batches) - len(batches) % self.num_replicas
        return iter(batches[self.rank : usable : self.num_replicas])
