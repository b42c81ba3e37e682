"""Training runtime of the port: the loop, layered-snapshot checkpointing
and fault tolerance, as ``repro.train.trainer``.

Checkpoint / restart is the paper's machinery reused: a resume after a
crash is a cold start from the newest snapshot, and content-addressed
chunks make adjacent checkpoints dedup.

* **async checkpointing**: the host copy of the train state is taken at the
  step boundary (``convert.train_state_to_flat``, which always copies: the
  optimizer updates the device tensors in place on the next step), then
  chunking, hashing and writing run on a background thread;
* **restart recovery**: ``resume()`` restores params, optimizer state, step
  and the data cursors from the snapshot ``LATEST`` names;
* **straggler mitigation**: a step-time watchdog reassigns data shards from
  slow loaders (shards are pure functions of (shard, step)).

Flat paths, shapes, dtypes and bfloat16-as-``uint16`` bits are those of
``convert.params_to_flat``, so a checkpoint of either package resumes in
the other and the two share chunk digests.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..convert import train_state_from_numpy, train_state_to_flat
from ..core import ChunkStore, take_snapshot
from ..core.restore import BasePool
from ..core.snapshot import SnapshotManifest
from ..data.pipeline import ShardedLoader
from ..device import DeviceLike, resolve_device
from ..launch.steps import make_train_state, make_train_step, train_state_shapes
from ..models import Model
from ..optim import OptimizerConfig

PyTree = Any


@dataclass
class TrainerConfig:
    workdir: str
    checkpoint_every: int = 50
    keep: int = 3
    watchdog_factor: float = 3.0   # shard slower than factor x median -> steal
    async_checkpoint: bool = True


def _write(store: ChunkStore, root: str, flat: Dict[str, np.ndarray], step: int,
           extra: Dict) -> str:
    m = take_snapshot(store, f"ckpt-{step:08d}", flat, kind="full", runtime="train",
                      device_state=extra)
    m.save(root)
    with open(os.path.join(root, "LATEST"), "w") as f:
        f.write(m.snapshot_id)
    return m.snapshot_id


class CheckpointWriter:
    """Background thread: host copy of the state -> chunked snapshot on disk."""

    def __init__(self, store: ChunkStore, root: str):
        self.store = store
        self.root = root
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self.written: List[str] = []

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                self.written.append(_write(self.store, self.root, *item))
            except Exception as e:  # broad-ok: kept here and re-raised by drain(); the loop keeps going
                self._error = e
            finally:
                self._q.task_done()

    def submit(self, flat: Dict[str, np.ndarray], step: int, extra: Dict) -> None:
        self._q.put((flat, step, extra))

    def drain(self) -> None:
        """Wait until every submitted snapshot is on disk; raise the first
        error a write met."""
        self._q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("a checkpoint write failed") from err

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=10)


class Trainer:
    def __init__(self, model: Model, opt_cfg: OptimizerConfig, loader: ShardedLoader,
                 tcfg: TrainerConfig, *, peer_loaders: Optional[List[ShardedLoader]] = None,
                 microbatches: int = 1, device: DeviceLike = None):
        self.model = model
        self.opt_cfg = opt_cfg
        self.loader = loader
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.peers = peer_loaders or []
        os.makedirs(tcfg.workdir, exist_ok=True)
        self.store = ChunkStore(os.path.join(tcfg.workdir, "store"))
        self.writer = CheckpointWriter(self.store, tcfg.workdir)
        self.step = 0
        self.state: Optional[PyTree] = None
        self._train_step = make_train_step(model, opt_cfg, microbatches=microbatches)
        self.metrics_log: List[Dict[str, float]] = []
        self.steals: List[Dict[str, int]] = []

    # -- init / resume -------------------------------------------------------

    def init_state(self, seed: int = 0) -> None:
        self.state = make_train_state(self.model, self.opt_cfg, seed, device=self.device)

    def latest_snapshot(self) -> Optional[str]:
        p = os.path.join(self.tcfg.workdir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return f.read().strip()

    def resume(self) -> bool:
        """Restore from the newest checkpoint; True if one was found.  The
        restore is a cold start: an eager batched chunk read, then the
        leaves onto this trainer's device."""
        snap_id = self.latest_snapshot()
        if snap_id is None:
            return False
        m = SnapshotManifest.load(self.tcfg.workdir, snap_id)
        pool = BasePool.load(self.store, m)
        host_flat = {path: pool.get(path) for path in m.arrays}
        self.state = train_state_from_numpy(
            host_flat, self.device, template=train_state_shapes(self.model, self.opt_cfg))
        self.step = int(m.device_state.get("step", 0))
        if "loader" in m.device_state:
            self.loader.load_state_dict(m.device_state["loader"])
        return True

    # -- checkpoint ------------------------------------------------------------

    def checkpoint(self) -> None:
        if self.state is None:
            raise RuntimeError("no train state: call init_state() or resume() first")
        flat = train_state_to_flat(self.state)  # host copies, at the step boundary
        extra = {"step": self.step, "loader": self.loader.state_dict(),
                 "mesh_fingerprint": ""}
        if self.tcfg.async_checkpoint:
            self.writer.submit(flat, self.step, extra)
        else:
            _write(self.store, self.tcfg.workdir, flat, self.step, extra)

    # -- watchdog --------------------------------------------------------------

    def _watchdog(self) -> None:
        """Steal shards from peers whose recent fetch time is pathological."""
        if not self.peers:
            return
        mine = np.median(self.loader.fetch_times[-5:]) if self.loader.fetch_times else 0
        for peer in self.peers:
            if not peer.fetch_times or not peer.owned:
                continue
            theirs = np.median(peer.fetch_times[-5:])
            if mine > 0 and theirs > self.tcfg.watchdog_factor * mine:
                shard = peer.owned[-1]
                at = peer.release(shard)
                self.loader.steal(shard, at)
                self.steals.append({"shard": shard, "at_step": at})

    # -- loop ------------------------------------------------------------------

    def train(self, num_steps: int, *, fail_at: Optional[int] = None) -> Dict:
        """Run ``num_steps``.  ``fail_at`` simulates a crash (raises) before
        that step, to exercise ``resume()``."""
        if self.state is None:
            raise RuntimeError("call init_state() or resume() first")
        t_start = time.perf_counter()
        for _ in range(num_steps):
            if fail_at is not None and self.step == fail_at:
                raise RuntimeError(f"simulated failure at step {self.step}")
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.loader.next().items()}
            t0 = time.perf_counter()
            self.state, metrics = self._train_step(self.state, batch)
            loss = float(metrics["loss"])  # waits for the step
            self.metrics_log.append({"step": self.step, "loss": loss,
                                     "grad_norm": float(metrics["grad_norm"]),
                                     "step_time": time.perf_counter() - t0})
            self.step += 1
            if self.step % self.tcfg.checkpoint_every == 0:
                self.checkpoint()
            self._watchdog()
        return {"steps": num_steps,
                "final_loss": self.metrics_log[-1]["loss"] if self.metrics_log else None,
                "wall": time.perf_counter() - t_start}

    def close(self) -> None:
        self.writer.close()
