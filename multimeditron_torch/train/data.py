"""Host-side training data loading.

Counterpart of ``multimeditron_tpu/train/data.py`` (which cannot be shared:
``multimeditron_tpu.train`` imports the JAX trainer). Datasets are
concatenated and shuffled; a pool of worker threads runs the numpy collator
so that host preprocessing overlaps device steps. The JAX module's process
workers (``worker_mode="process"``) are not ported.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)


def is_dataset_folder(folder: str) -> bool:
    return os.path.exists(os.path.join(folder, "dataset_info.json")) and os.path.exists(
        os.path.join(folder, "state.json")
    )


def build_datasets(dataset_configs: List[Dict[str, Any]], seed: int = 0, num_proc: int = 1):
    """Load + concatenate + shuffle packed datasets, as the JAX package does."""
    from datasets import Dataset, concatenate_datasets, load_dataset, load_from_disk

    parts = []
    for ds_config in dataset_configs:
        path = ds_config["packed_path"]
        if is_dataset_folder(path):
            ds = load_from_disk(path)
        elif path.endswith(".jsonl"):
            from multimeditron_torch.utils.jsonl import JSONLGenerator

            gen = JSONLGenerator(path)
            ds = Dataset.from_generator(lambda gen=gen: iter(gen))
        elif path.endswith(".parquet"):
            ds = load_dataset("parquet", data_files=path)["train"]
        else:
            ds = load_dataset(path, num_proc=num_proc or None)["train"]
        parts.append(ds)
    return concatenate_datasets(parts).shuffle(seed=seed)


def _rank_and_world() -> tuple[int, int]:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


class DataLoader:
    """Shuffled epoch iterator: dataset -> collated numpy batches, with a
    small pipeline of background collation threads.

    Every process draws the SAME per-epoch permutation and takes its
    contiguous slice of each global batch (the DistributedSampler contract).
    ``batch_size`` is the GLOBAL batch size; each process yields
    ``batch_size // process_count`` samples per step. Rank and world size
    come from ``torch.distributed`` when it is initialised, else 0 of 1.
    A batch whose collation raises is logged and skipped when
    ``skip_errors`` is set.
    """

    def __init__(
        self,
        dataset: Sequence[Dict[str, Any]],
        collator: Callable[[List[Dict[str, Any]]], Dict[str, Any]],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 2,
        num_epochs: Optional[int] = None,
        skip_errors: bool = True,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.dataset = dataset
        self.collator = collator
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.num_epochs = num_epochs
        self.skip_errors = skip_errors
        if process_count is None:
            process_index, process_count = _rank_and_world()
        if batch_size % process_count:
            raise ValueError(
                f"Global batch size {batch_size} must divide evenly over "
                f"{process_count} processes"
            )
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch_size = batch_size // process_count
        if drop_last and len(dataset) < batch_size:
            raise ValueError(
                f"Dataset has {len(dataset)} samples but the global batch "
                f"size is {batch_size} (drop_last would yield no batches)"
            )

    def _index_batches(self, epoch: int) -> Iterator[List[int]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(n)
        lb = self.local_batch_size
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size and (self.drop_last or self.process_count > 1):
                # several processes always drop the partial global batch: a
                # ragged split would desynchronise their step counts
                return
            yield list(idx[self.process_index * lb : (self.process_index + 1) * lb])

    def _result(self, fut) -> Optional[Dict[str, Any]]:
        try:
            return fut.result()
        except Exception:
            if not self.skip_errors:
                raise
            logger.exception("Skipping batch that failed to collate")
            return None

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        epoch = 0
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            while self.num_epochs is None or epoch < self.num_epochs:
                pending = []
                for idx in self._index_batches(epoch):
                    samples = [self.dataset[int(i)] for i in idx]
                    pending.append(pool.submit(self.collator, samples))
                    while len(pending) > self.num_workers:  # a bounded pipeline
                        batch = self._result(pending.pop(0))
                        if batch is not None:
                            yield batch
                for fut in pending:
                    batch = self._result(fut)
                    if batch is not None:
                        yield batch
                epoch += 1
