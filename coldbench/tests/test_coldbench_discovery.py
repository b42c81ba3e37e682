"""A configuration, a cell and a per-layer metric dropped into a copy of
the folder are found by name, with no edit to a file that is there."""

import json
import os
import shutil

from conftest import BENCH, DATA

import harness
import spec


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "bench"
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), base / sub)
    cfg = json.load(open(os.path.join(DATA, "configs", "tiny-ssm.json")))
    cfg["name"] = "tiny-new"
    (base / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    wl = json.load(open(os.path.join(DATA, "workloads", "tiny-ssm.warm.json")))
    wl.update(name="tiny-new.burst", config="tiny-new", loop="open",
              arrivals={"kind": "mmpp", "rate_per_s": 20.0, "burst_factor": 4.0})
    (base / "workloads" / "tiny-new.burst.json").write_text(json.dumps(wl))
    (base / "metrics" / "new_count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.records))\n")
    man = {"workloads": [{"name": "tiny-new.burst"}],
           "per_layer": [{"name": "new_count", "workloads": ["tiny-new.burst"]},
                         {"name": "idle_pct", "workloads": ["other"]}]}
    names = [m["name"] for m in spec.metrics_for(man, "tiny-new.burst", "per_layer")]
    assert names == ["new_count"]
    out = harness.run_cell("tiny-new.burst", 21, 1.0, True, device="cpu", base=str(base),
                           per_layer=names)
    assert out["correct"], out["checks"]
    assert out["per_layer"]["new_count"] == out["attempted"] > 0
