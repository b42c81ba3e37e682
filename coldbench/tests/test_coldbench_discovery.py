"""A configuration, a cell and a per-layer metric dropped into a copy of
the folder are found by name, with no edit to a file that is there."""

import filecmp
import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, DATA, ROOT

import harness
import spec


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "bench"
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), base / sub)
    cfg = json.load(open(os.path.join(DATA, "configs", "tiny-ssm.json")))
    cfg["name"] = "tiny-new"
    (base / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    shutil.copy(os.path.join(DATA, "configs", "tiny-ssm.py"), base / "configs" / "tiny-new.py")
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


#: a reader a configuration of a new family could bring: the port's
#: ``model.layer`` spans per forward, which turns the recorder on
LAYER_SPANS = '''SPANS = True


def read(ctx):
    if not ctx.spans:
        return None
    spans = ctx.spans["spans"]
    fwd = sum(s.name == "worker.forward" for s in spans)
    return sum(s.name == "model.layer" for s in spans) / fwd if fwd else None
'''

RUN = """
import json, sys
sys.path[:0] = [{src!r}, {bench!r}]
import harness
out = harness.run_cell("tiny-hybrid.warm", 23, 1.0, True, device="cpu", base={bench!r},
                       per_layer=["fwd_mfu_pct", "flash_roofline_pct",
                                  "ssd_scan_roofline_pct", "layers_per_forward"])
print(json.dumps({{"correct": out["correct"], "checks": out["checks"],
                  "per_layer": out["per_layer"], "attempted": out["attempted"]}}))
"""


def test_a_hybrid_family_is_added_by_new_files_alone(tmp_path):
    """A copy of the benchmark's folder, with the tiny-hybrid configuration,
    its module, its workload and a span reader added and no file that is
    there edited, serves the hybrid and judges it correct, in a process
    that imports the copy's modules."""
    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {os.path.relpath(os.path.join(d, f), bench)
              for d, _, fs in os.walk(bench) for f in fs}
    for sub, name in (("configs", "tiny-hybrid.json"), ("configs", "tiny-hybrid.py"),
                      ("workloads", "tiny-hybrid.warm.json")):
        shutil.copy(os.path.join(DATA, sub, name), bench / sub / name)
    (bench / "metrics" / "layers_per_forward.py").write_text(LAYER_SPANS)
    r = subprocess.run([sys.executable, "-c", RUN.format(src=os.path.join(ROOT, "src"),
                                                         bench=str(bench))],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["per_layer"]["fwd_mfu_pct"] > 0
    assert out["per_layer"]["layers_per_forward"] == 4.0
    # no CUDA trace on the CPU: the rooflines read nothing
    assert "flash_roofline_pct" not in out["per_layer"]
    for rel in before:
        assert filecmp.cmp(os.path.join(BENCH, rel), bench / rel, shallow=False), rel
