"""Serve a small model through the port's multi-worker cluster on the GPU
under every cold-start strategy (including the planner-driven ``auto``);
print the Fig.5-style comparison and the fleet metrics.

Run:  PYTHONPATH=src python examples/torch_serve_coldstart.py            # on the GPU
      PYTHONPATH=src python examples/torch_serve_coldstart.py --device cpu
"""

import argparse
import json
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import (
    ColdStartOptions,
    InvocationRequest,
    Strategy,
    build_cluster,
    replay_cluster_trace,
    summarize,
)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
device = resolve_device(ap.parse_args().device)
# float32 matmuls in full float32 (reference numerics)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

root = tempfile.mkdtemp(prefix="torch_serve_example_")
cfg = reduced(get_config("gemma-2b"))
model = build_model(cfg)
cluster, fns = build_cluster(root, cfg, model, n_workers=2, n_functions=4, device=device)

with cluster:
    # one typed invocation, end to end
    req = InvocationRequest(
        function=fns[0].name,
        tokens=np.zeros((1, 8), np.int32),
        options=ColdStartOptions(strategy=Strategy.AUTO),
    )
    result = cluster.submit(req).result()
    assert np.isfinite(result.output).all()
    print(f"{result.function}: cold={result.cold} "
          f"requested={result.requested} ran={result.strategy} "
          f"boot={result.boot_s*1e3:.1f}ms exec={result.exec_s*1e3:.1f}ms "
          f"worker={result.worker_id} device={device}")

    # the full strategy comparison over a replayed trace
    for strategy in Strategy:
        results = replay_cluster_trace(
            cluster, fns, n_requests=16, cold_fraction=0.5,
            strategy=strategy, seed=0,
        )
        print(json.dumps(summarize(strategy, results)))

    print(json.dumps({"fleet": cluster.metrics()["pool"]}))
