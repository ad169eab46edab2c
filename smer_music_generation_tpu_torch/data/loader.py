"""Batch collation + epoch iterator over packed event groups.

Replaces the reference's torch ``DataLoader`` + ``collate_mlm_*`` pair
(``dataset.py:802-925``, ``train.py:481-553``) with a plain numpy iterator.

TPU-first change: sequences are padded to *bucketed* fixed lengths
(multiples of ``bucket``) rather than the batch max, so XLA compiles a
small number of shapes once instead of recompiling per batch.

Host copy of ``smer_music_generation_tpu/data/loader.py`` for the PyTorch port,
which imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..vocab import WordVocab
from .masking import MaskingConfig, MaskingPipeline


def _bucket(n: int, bucket: int, cap: int) -> int:
    return min(int(np.ceil(max(n, 1) / bucket)) * bucket, cap)


def collate(
    groups: Sequence,
    bucket: int = 128,
    max_src: int = 2400,
    max_tgt: int = 2400,
    row_bucket: int = 8,
    eos_id: int = 1,
) -> Optional[Dict[str, np.ndarray]]:
    """Stack (tokens, decoder_in, decoder_target) triples into padded arrays.

    Returns ``{"input", "target_in", "target_out", "input_pad_mask",
    "target_pad_mask"}`` with pad id 0 and boolean masks (True = pad),
    matching the reference collate contract.

    The ROW count is bucketed too (``row_bucket``): packed groups hold a
    variable number of sequences, and on TPU every distinct (B, src, tgt)
    shape is a separate XLA compile — over a remote-compile backend an
    unbucketed batch dim turns epoch 1 into an hour of compilation.
    Dummy rows carry a single ``<eos>`` input/decoder-input token (so no
    attention row has all keys masked -> no NaN softmax) and an all-pad
    target (so they contribute exactly zero loss and zero accuracy count).
    """
    groups = [g for g in groups if g is not None]
    if not groups:
        return None
    tokens: List[np.ndarray] = []
    dins: List[np.ndarray] = []
    dtgts: List[np.ndarray] = []
    for g in groups:
        tokens.extend(g[0])
        dins.extend(g[1])
        dtgts.extend(g[2])

    src_len = _bucket(max(len(t) for t in tokens), bucket, max_src)
    tgt_len = _bucket(max(max(len(d) for d in dins), max(len(d) for d in dtgts)), bucket, max_tgt)

    n_rows = len(tokens)
    # round UP to a multiple of row_bucket, uncapped (a cap of n_rows would
    # silently disable bucketing for every n_rows > row_bucket)
    B = (
        int(np.ceil(n_rows / row_bucket)) * row_bucket if row_bucket > 1 else n_rows
    )
    inp = np.zeros((B, src_len), dtype=np.int32)
    tin = np.zeros((B, tgt_len), dtype=np.int32)
    tout = np.zeros((B, tgt_len), dtype=np.int32)
    for i, (t, di, dt) in enumerate(zip(tokens, dins, dtgts)):
        inp[i, : min(len(t), src_len)] = t[:src_len]
        tin[i, : min(len(di), tgt_len)] = di[:tgt_len]
        tout[i, : min(len(dt), tgt_len)] = dt[:tgt_len]
    inp[n_rows:, 0] = eos_id
    tin[n_rows:, 0] = eos_id
    return {
        "input": inp,
        "target_in": tin,
        "target_out": tout,
        "input_pad_mask": inp == 0,
        "target_pad_mask": tin == 0,
    }


@dataclass
class LoaderConfig:
    batch_size: int = 2  # groups per batch (each group packs <=2200 tokens)
    bucket: int = 128
    max_src: int = 2400
    max_tgt: int = 2400
    row_bucket: int = 8  # batch-dim bucket (see collate)
    pretraining: bool = True
    # shape-binned batching (PERFORMANCE.md Finding 8): pool masked rows
    # across pack groups into per-(src_bucket, tgt_bucket) bins and emit
    # fixed-row batches when a bin fills.  Kills the two padding-waste
    # sources of the group-per-batch path measured by
    # scripts/padding_audit.py — 65% dummy rows (groups hold ~2.8 windows,
    # padded to 8) and row-length variance within a batch (FLOP
    # utilization 0.19-0.21 at the shipped defaults).  Same per-epoch data
    # and masking distribution; only batch composition changes, so it is
    # opt-in until a full run validates training parity.
    bin_rows: bool = False
    rows_per_batch: int = 0  # 0 = row_bucket


class BatchLoader:
    """Epoch iterator: shuffle groups, mask, collate.

    Divergence from the reference's length-bucketed random indexing
    (``dataset.py:59-161``): groups are visited in a seeded random
    permutation per epoch — same marginal distribution, simpler and
    deterministic under one RNG.
    """

    def __init__(
        self,
        vocab: WordVocab,
        batches: Sequence[Sequence[Sequence[str]]],
        loader_config: LoaderConfig,
        masking_config: MaskingConfig,
        seed: int = 99,
    ):
        self.vocab = vocab
        self.batches = list(batches)
        self.cfg = loader_config
        self.pipeline = MaskingPipeline(vocab, masking_config, seed=seed)
        self.rng = np.random.default_rng(seed + 1)

    def __len__(self) -> int:
        if self.cfg.bin_rows:
            # binned epochs emit a data-dependent batch count (rows pool
            # across groups into shape bins); a fixed formula would lie to
            # progress bars/schedulers (ADVICE r4) — count a dry epoch
            raise TypeError(
                "len() is undefined for a shape-binned loader: the batch "
                "count depends on the masked shapes drawn this epoch; "
                "iterate (or count one epoch) instead"
            )
        return int(np.ceil(len(self.batches) / self.cfg.batch_size))

    def _mask_group(self, j: int):
        prepared = self.pipeline.prepare_group(self.batches[j])
        if self.cfg.pretraining:
            return self.pipeline.random_word(prepared)
        return self.pipeline.mask_bars(prepared)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.cfg.bin_rows:
            yield from self._iter_binned()
            return
        order = self.rng.permutation(len(self.batches))
        bs = self.cfg.batch_size
        for i in range(0, len(order), bs):
            groups = [self._mask_group(j) for j in order[i : i + bs]]
            batch = collate(
                groups, self.cfg.bucket, self.cfg.max_src, self.cfg.max_tgt,
                row_bucket=self.cfg.row_bucket, eos_id=self.vocab.eos_index,
            )
            if batch is not None:
                yield batch

    def _iter_binned(self) -> Iterator[Dict[str, np.ndarray]]:
        """Shape-binned epoch (see LoaderConfig.bin_rows).

        Masked rows stream into per-(src_bucket, tgt_bucket) bins; a bin
        emits one batch of exactly ``rows_per_batch`` rows when full, and
        partial bins flush (dummy-row padded) at epoch end.  Deterministic
        under the loader seed: group order is the same permutation as the
        unbinned path and flush order is sorted by bin key.
        """
        rows = self.cfg.rows_per_batch or self.cfg.row_bucket
        bins: Dict[tuple, tuple] = {}
        order = self.rng.permutation(len(self.batches))
        for j in order:
            g = self._mask_group(int(j))
            if g is None:
                continue
            for t, di, dt in zip(g[0], g[1], g[2]):
                key = (
                    _bucket(len(t), self.cfg.bucket, self.cfg.max_src),
                    _bucket(max(len(di), len(dt)), self.cfg.bucket, self.cfg.max_tgt),
                )
                slot = bins.setdefault(key, ([], [], []))
                slot[0].append(t)
                slot[1].append(di)
                slot[2].append(dt)
                if len(slot[0]) == rows:
                    yield collate(
                        [bins.pop(key)], self.cfg.bucket, self.cfg.max_src,
                        self.cfg.max_tgt, row_bucket=rows,
                        eos_id=self.vocab.eos_index,
                    )
        for key in sorted(bins):
            yield collate(
                [bins[key]], self.cfg.bucket, self.cfg.max_src,
                self.cfg.max_tgt, row_bucket=rows, eos_id=self.vocab.eos_index,
            )


class Prefetcher:
    """Background-thread batch prefetch (depth-bounded).

    The reference's DataLoader used one worker process
    (``train.py:504,531``); here host-side masking/collation overlaps the
    device step via a daemon thread and a small queue.  Wrap any iterable
    of batches; iteration order is preserved.
    """

    def __init__(self, iterable, depth: int = 2):
        import queue as _queue
        import threading

        self._queue: "_queue.Queue" = _queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._error = None
        self._stop = threading.Event()

        def worker():
            try:
                for item in iterable:
                    # bounded put that notices close(): an abandoned
                    # consumer must not leave this thread blocked forever
                    while not self._stop.is_set():
                        try:
                            self._queue.put(item, timeout=0.1)
                            break
                        except _queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as exc:  # surfaced on the consumer side
                self._error = exc
            finally:
                # same patient put as items: with a full queue put_nowait
                # would DROP the sentinel and block the consumer forever
                while not self._stop.is_set():
                    try:
                        self._queue.put(self._sentinel, timeout=0.1)
                        break
                    except _queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self):
        """Release the worker thread and wake any blocked consumer
        (idempotent)."""
        self._stop.set()
        # join FIRST: the worker exits within its 0.1s put timeout once
        # _stop is set.  Draining before the join raced a final put() —
        # the worker could refill a depth-1 queue between the drain and
        # the sentinel, the Full was swallowed, and a consumer blocked in
        # get() never woke.
        self._thread.join(timeout=2.0)
        while True:
            try:
                self._queue.get_nowait()
            except Exception:
                break
        # wake consumers blocked in get(): no producer is live, so the
        # just-drained queue has room for the sentinel
        try:
            self._queue.put_nowait(self._sentinel)
        except Exception:
            pass

    def __del__(self):  # constructed-but-never-iterated: stop the poll loop
        self._stop.set()

    def __iter__(self):
        try:
            while True:
                item = self._queue.get()
                if item is self._sentinel:
                    if self._error is not None:
                        raise self._error
                    return
                yield item
        finally:
            self.close()
