"""End-to-end training entry point of the port, the CLI of ``repro.launch.train``
with a ``--device`` (the GPU unless ``cpu`` is asked for):

    PYTHONPATH=src python -m repro_torch.launch.train --device cuda \\
        --arch stablelm-3b --steps 200 --batch 16 --seq 128 --workdir runs/a

The sharded deterministic data pipeline, the train step (the flash
backward kernel on the card), async layered-snapshot checkpointing, crash
and resume (``--simulate-failure N`` exits 17 after checkpointing; rerun
with ``--resume``) and straggler work-stealing (``--straggler``).  As in the
reference, ``--reduced`` is always on (``store_true`` with default True):
the smoke-size configuration of the family.  Writes ``metrics.jsonl`` (one
line per step of this run) into the workdir.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ..configs import get_config, reduced
from ..data.pipeline import ShardedLoader
from ..device import resolve_device
from ..models import build_model
from ..optim import OptimizerConfig
from ..train.trainer import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure", type=int, default=None,
                    help="crash at this step (then rerun with --resume)")
    ap.add_argument("--straggler", action="store_true",
                    help="simulate a slow peer loader and steal its shard")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # float32 stays float32 on the card: no TF32 in products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg, remat=False)
    opt = OptimizerConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)

    def loader(owned, delay_s=0.0):
        return ShardedLoader(seed=0, vocab=cfg.vocab_size, seq_len=args.seq,
                             batch_per_shard=args.batch // 2, num_shards=2, owned=owned,
                             delay_s=delay_s)

    data, peers = loader([0, 1]), []
    if args.straggler:
        data, peers = loader([0]), [loader([1], delay_s=0.5)]

    tcfg = TrainerConfig(workdir=args.workdir, checkpoint_every=args.checkpoint_every)
    trainer = Trainer(model, opt, data, tcfg, peer_loaders=peers,
                      microbatches=args.microbatches, device=device)
    if args.resume and trainer.resume():
        print(f"[train] resumed from step {trainer.step}")
    else:
        trainer.init_state(seed=0)
        print("[train] fresh start")

    try:
        summary = trainer.train(args.steps - trainer.step, fail_at=args.simulate_failure)
    except RuntimeError as e:
        trainer.checkpoint()
        trainer.writer.drain()
        trainer.close()
        print(f"[train] CRASH: {e} — state checkpointed; rerun with --resume")
        raise SystemExit(17)

    trainer.checkpoint()
    trainer.writer.drain()
    first = trainer.metrics_log[0]["loss"] if trainer.metrics_log else None
    last = trainer.metrics_log[-1]["loss"] if trainer.metrics_log else None
    print(json.dumps({
        "arch": cfg.name, "device": str(device), "steps": trainer.step,
        "first_loss": first, "final_loss": last,
        "loss_decreased": bool(first and last and last < first),
        "steals": trainer.steals,
        "stored_mb": round(trainer.store.stored_bytes() / 2**20, 1),
        "wall_s": round(summary["wall"], 1),
    }, indent=1))
    with open(os.path.join(args.workdir, "metrics.jsonl"), "w") as f:
        for m in trainer.metrics_log:
            f.write(json.dumps(m) + "\n")
    trainer.close()


if __name__ == "__main__":
    main()
