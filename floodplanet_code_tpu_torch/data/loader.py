"""Batch assembly and host->device prefetch.

The PyTorch port's copy of ``floodplanet_code_tpu/data/loader.py``.
Replaces the reference's torch DataLoader usage (fit.py:56-63, infer.py:79-83)
with:

- ``BatchLoader``: threaded example loading (GeoTIFF windowed reads release
  the GIL inside the native reader) assembled into fixed-shape NHWC numpy
  batches. Training drops the ragged final batch to keep one shape;
  evaluation pads it with duplicated examples and a ``valid`` mask so every
  tile is scored exactly once (the reference simply runs batch-size-1
  evaluation, predict.py:206-233). Unchanged from the JAX package.
- ``device_prefetch``: a background thread copies each batch into pinned
  host memory and on to the card on a side CUDA stream, so the copy of
  batch k+1 overlaps the forward of batch k. The consumer's stream waits
  on an event recorded after the copy.

The ``metadata`` field (python objects) stays host-side, mirroring the
reference's tensors_and_lists_collate_fn (datasets/__init__.py:14-30).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


class BatchLoader:
    """Iterable over fixed-shape batches of a FloodPlanetDataset."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        n_workers: int = 4,
        drop_last: bool = False,
        seed: int | None = 0,
        output_metadata: bool = False,
        pad_final: bool = True,
        process_shard: tuple[int, int] | None = None,
    ):
        """``batch_size`` is always the GLOBAL batch size.

        ``process_shard=(process_id, process_count)`` makes this host load
        only its slice of every global batch: all hosts partition the SAME
        seeded epoch order, so batch counts and global example placement
        agree across processes with zero coordination traffic (multi-host
        data sharding, SURVEY.md §5.8).

        Batches always have exactly ``batch_size`` examples: a short final
        batch is either dropped (``drop_last=True``) or padded to full size
        with duplicated examples plus a ``valid`` mask (``pad_final=True``).
        With both flags False a ragged final batch raises ValueError — the
        fixed global batch structure is what multi-host slicing and the
        one-compiled-shape contract rely on; there is no ragged-batch mode.
        """
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.n_workers = max(1, n_workers)
        self.drop_last = drop_last
        self.output_metadata = output_metadata
        self.pad_final = pad_final
        self.process_shard = process_shard
        if process_shard is not None:
            pid, pcount = process_shard
            if batch_size % pcount != 0:
                raise ValueError(
                    f"global batch size {batch_size} not divisible by "
                    f"{pcount} processes"
                )
            if not 0 <= pid < pcount:
                raise ValueError(f"bad process_shard {process_shard}")
        self._seed = 0 if seed is None else int(seed)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch whose shuffle order the next iteration uses.

        The order is a pure function of (seed, epoch) — not of how many
        epochs this loader object has already served — so a fit resumed at
        epoch k iterates exactly the order the uninterrupted run would
        have (train.fit calls this every epoch; the DistributedSampler
        pattern)."""
        self._epoch = int(epoch)

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self._seed, self._epoch)).shuffle(order)
        self._epoch += 1
        return order

    def _assemble(self, examples: list, valid_flags: np.ndarray) -> dict:
        batch = {
            "image": np.stack([e["image"] for e in examples]),
            "target": np.stack([e["target"] for e in examples]),
            "mean": np.stack([e["mean"] for e in examples]),
            "std": np.stack([e["std"] for e in examples]),
            "valid": np.asarray(valid_flags, bool),
        }
        if self.output_metadata:
            batch["metadata"] = [e.get("metadata") for e in examples]
        return batch

    def __iter__(self) -> Iterator[dict]:
        order = self._epoch_order()
        n = len(order)
        use_batch_api = hasattr(self.dataset, "load_batch")

        # Partition the epoch into GLOBAL batches up front. A short final
        # batch is padded to full size by repeating its last index, with a
        # validity flag per position ('valid' masks padding out of metrics
        # and stitching). This fixed global structure is what lets each
        # host slice out its share deterministically.
        batches: list[tuple[list[int], np.ndarray]] = []
        position = 0
        while position < n:
            end = min(position + self.batch_size, n)
            if end - position < self.batch_size and self.drop_last:
                break
            idx = [int(order[i]) for i in range(position, end)]
            flags = np.ones(self.batch_size, bool)
            if len(idx) < self.batch_size:
                if not self.pad_final:
                    raise ValueError(
                        "final batch is ragged; enable pad_final or drop_last"
                    )
                flags[len(idx) :] = False
                idx = idx + [idx[-1]] * (self.batch_size - len(idx))
            batches.append((idx, flags))
            position = end

        if self.process_shard is not None:
            # This host loads only its slice of every global batch.
            pid, pcount = self.process_shard
            local = self.batch_size // pcount
            batches = [
                (idx[pid * local : (pid + 1) * local],
                 flags[pid * local : (pid + 1) * local])
                for idx, flags in batches
            ]

        def load(batch_indices: list[int]) -> list[dict]:
            if use_batch_api:
                # One native batch-read call (C++ thread pool inside).
                return self.dataset.load_batch(
                    batch_indices, self.output_metadata
                )
            return [
                self.dataset.load_example(i, self.output_metadata)
                for i in batch_indices
            ]

        with ThreadPoolExecutor(max_workers=self.n_workers) as pool:
            inflight = 3  # batches in flight
            futures = {
                i: pool.submit(load, batches[i][0])
                for i in range(min(inflight, len(batches)))
            }
            for b in range(len(batches)):
                examples = futures.pop(b).result()
                nxt = b + inflight
                if nxt < len(batches):
                    futures[nxt] = pool.submit(load, batches[nxt][0])
                yield self._assemble(examples, batches[b][1])


def device_prefetch(iterator, device, size: int = 2):
    """Move batches to ``device`` ahead of consumption (double buffering).

    numpy leaves become tensors of the same shape and dtype on ``device``;
    python-object leaves (metadata) pass through untouched. For a CUDA
    device the host side is pinned and the copy runs on a side stream; each
    yielded batch is already ordered before later work on the consumer's
    current stream. For the CPU the leaves are wrapped without a copy.
    """
    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch):
        out = {}
        for key, value in batch.items():
            if isinstance(value, np.ndarray):
                value = torch.from_numpy(value)
                if side is not None:
                    with torch.cuda.stream(side):
                        value = value.pin_memory().to(device, non_blocking=True)
            out[key] = value
        ready = None
        if side is not None:
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def take(item):
        out, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(ready)
            for value in out.values():
                if isinstance(value, torch.Tensor):
                    # Allocated on the side stream, used on this one: keep
                    # the caching allocator from recycling it too early.
                    value.record_stream(current)
        return out

    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    error_holder = []
    stop = threading.Event()

    def _put(item) -> bool:
        # Bounded put that gives up when the consumer is gone. A plain
        # q.put() blocks FOREVER if the consumer abandons the generator
        # (e.g. a caller stops iterating mid-dataset) — each leak pins
        # this thread plus its loader pool, and enough of them exhaust the
        # process's native threads.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not _put(put(batch)):
                    return
        except BaseException as exc:  # propagate loader errors to consumer
            error_holder.append(exc)
        finally:
            _put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if error_holder:
                    raise error_holder[0]
                return
            yield take(item)
    finally:
        stop.set()
        # Drain so a producer blocked on a full queue can observe `stop`.
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=5.0)
