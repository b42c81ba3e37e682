"""Deterministic sharded data pipeline with prefetch and work-stealing.

Key property for fault tolerance: batches are a pure function of
(shard, step) via counter-based hashing, so

* a restarted worker regenerates exactly the batches it would have seen
  (checkpointing the data cursor = storing one integer in device_state);
* a straggling shard's work can be *stolen* by any other host with no data
  movement — the thief just evaluates the same pure function.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np


def _batch_from_counter(seed: int, shard: int, step: int, batch: int, seq: int,
                        vocab: int) -> Dict[str, np.ndarray]:
    """Pure function (seed, shard, step) → batch (counter-based PRNG).

    Tokens follow a Zipf-like unigram distribution (natural-language-ish)
    rather than uniform noise: uniform tokens make the irreducible loss
    exactly log(vocab), so nothing is learnable and loss-goes-down tests
    measure only jitter.  A skewed unigram gives optimization a real
    gradient (the unigram bias) while staying a pure counter-based stream.
    """
    ss = np.random.SeedSequence(entropy=seed, spawn_key=(shard, step))
    rng = np.random.Generator(np.random.Philox(ss))
    raw = rng.zipf(1.3, size=(batch, seq + 1))
    tokens = ((raw - 1) % vocab).astype(np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


@dataclass
class ShardCursor:
    shard: int
    step: int = 0


class ShardedLoader:
    """Per-host loader over `num_shards` logical shards.

    ``owned`` shards are produced locally with a background prefetch thread
    (double buffering).  ``steal(shard)`` permanently reassigns a shard to
    this loader — the straggler-mitigation hook used by the trainer.
    """

    def __init__(
        self,
        *,
        seed: int,
        vocab: int,
        seq_len: int,
        batch_per_shard: int,
        num_shards: int,
        owned: Optional[List[int]] = None,
        prefetch: int = 2,
        delay_s: float = 0.0,  # simulated per-fetch latency (tests)
    ):
        self.seed = seed
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch_per_shard = batch_per_shard
        self.num_shards = num_shards
        self.owned = list(owned) if owned is not None else list(range(num_shards))
        self.cursors: Dict[int, ShardCursor] = {s: ShardCursor(s) for s in self.owned}
        self.delay_s = delay_s
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fetch_times: List[float] = []

    # -- shard management ---------------------------------------------------

    def steal(self, shard: int, at_step: int) -> None:
        """Take ownership of a shard starting from `at_step`."""
        if shard not in self.cursors:
            self.owned.append(shard)
            self.cursors[shard] = ShardCursor(shard, at_step)

    def release(self, shard: int) -> int:
        """Give up a shard; returns the step the new owner must resume at."""
        cur = self.cursors.pop(shard)
        self.owned.remove(shard)
        return cur.step

    # -- batch production -----------------------------------------------------

    def _produce(self) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        if self.delay_s:
            time.sleep(self.delay_s)
        parts = []
        for s in self.owned:
            cur = self.cursors[s]
            parts.append(
                _batch_from_counter(self.seed, s, cur.step, self.batch_per_shard,
                                    self.seq_len, self.vocab)
            )
            cur.step += 1
        out = {
            k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]
        }
        self.fetch_times.append(time.perf_counter() - t0)
        return out

    def start(self) -> None:
        def run():
            while not self._stop.is_set():
                b = self._produce()
                while not self._stop.is_set():
                    try:
                        self._q.put(b, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def next(self) -> Dict[str, np.ndarray]:
        if self._thread is None:
            return self._produce()
        return self._q.get()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    # -- checkpointing ---------------------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        return {str(s): c.step for s, c in self.cursors.items()}

    def load_state_dict(self, d: Dict[str, int]) -> None:
        for s, step in d.items():
            s = int(s)
            self.cursors[s] = ShardCursor(s, int(step))
            if s not in self.owned:
                self.owned.append(s)
