"""The control of the check: the reference in float8 put in the program's place.

    python3 coldbench/control.py --workload stablelm-3b.warm-docs --seeds 1,2,3

For each seed it makes the run's inputs (base weights, deltas, tokens),
takes as many of the seed's requests as a run compares (the longest length
among them), and reads the check's number for the float8 reference's
outputs against the float32 reference: the widest gap of the first 8
logits of every row's last position.  A sound control reads above the
cell's limit.  It prints one JSON line per seed.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import inputs  # noqa: E402
import spec  # noqa: E402
import traffic  # noqa: E402
from harness import variant_weights  # noqa: E402
from reference import logit_gap  # noqa: E402


def requests_of(wl, seed, n):
    """The seed's first ``n`` requests, the last one replaced by the first
    of the longest length where none of them has it."""
    if wl["loop"] == "open":
        stream = iter(traffic.open_schedule(wl, 60.0, seed))
    else:
        stream = traffic.closed_stream(wl, seed)
    picked = [next(stream) for _ in range(n)]
    top = max(wl["seq_lens"])
    if all(a.seq != top for a in picked):
        picked[-1] = next(a for a in stream if a.seq == top)
    return picked


def control_gap(cell, seed, device, base=HERE, n=None):
    """(gap of the float8 reference, requests compared) for one seed."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import build_params

    wl = spec.load_workload(cell, base)
    cfgd = spec.load_config(wl["config"], base)
    Reference = spec.load_model(wl["config"], base).Reference
    cfg = ModelConfig(name=cfgd["name"], **spec.model_fields(cfgd))
    dev = torch.device(device)
    flat = inputs.flatten(inputs.make_base(build_params, cfg, seed, dev))
    funcs = inputs.make_functions(wl["functions"], flat, seed)
    exact, low = Reference(cfgd), Reference(cfgd, quant="fp8")
    reqs = requests_of(wl, seed, n or int(wl["check"]["sample"]))
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gap = 0.0
    try:
        for a in reqs:
            f = funcs[a.fn]
            W = variant_weights(flat, f.delta, dev)
            toks = torch.from_numpy(traffic.tokens(cfg.vocab_size, int(wl["batch"]), a.seq,
                                                   a.tok_seed, f.rows)).to(dev)
            out = low.last_logits(W, toks)[:, :8].double().cpu().numpy()
            gap = max(gap, logit_gap(out, exact.last_logits(W, toks)))
            del W
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return gap, len(reqs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    limit = spec.load_workload(args.workload)["check"]["logit_err"]
    for s in args.seeds.split(","):
        t = time.perf_counter()
        gap, n = control_gap(args.workload, int(s), args.device)
        print(json.dumps({"workload": args.workload, "seed": int(s), "control_logit_err": gap,
                          "limit": limit, "fails": gap > limit, "compared": n,
                          "seconds": time.perf_counter() - t}), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
