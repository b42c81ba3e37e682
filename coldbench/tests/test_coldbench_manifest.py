"""BENCHMARK.json against the contract's character rules, the files it
names, and the model families the benchmark may not use."""

import ast
import json
import os
import re

from conftest import BENCH, ROOT

import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
EXCLUDED = re.compile(r"gemma|paligemma|llama|qwen3\.?5|gpt-?oss", re.IGNORECASE)


def _man():
    return spec.manifest(ROOT)


def test_names_and_units_use_allowed_characters():
    man = _man()
    names = [c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]]
    names += [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    names += [w["config"] for w in man["workloads"]] + [w["traffic"] for w in man["workloads"]]
    names += [k for c in man["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in man["end_to_end"] + man["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in man[group]]
        assert len(seen) == len(set(seen)), group
    texts = [w["why"] for w in man["workloads"]] + [c["source"] for c in man["configs"]]
    texts += [m["layer"] for m in man["per_layer"]] + list(man["command"])
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert len(json.dumps(man)) < 64 * 1024


def test_every_name_finds_its_file():
    man = _man()
    for c in man["configs"]:
        assert c["file"] == f"coldbench/configs/{c['name']}.json"
        assert spec.load_config(c["name"])["reduced"] == c["reduced"]
        mod = spec.load_model(c["name"])
        assert all(callable(getattr(mod, f, None))
                   for f in ("Reference", "forward_flops", "kernel_calls")), c["name"]
    for w in man["workloads"]:
        wl = spec.load_workload(w["name"])
        assert wl["config"] == w["config"] and w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] == 1
    e2e = {m["name"] for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
    for cell in cells:
        layer = spec.metrics_for(man, cell, "per_layer")
        assert layer and {m["moves"] for m in layer} <= e2e
    assert "setup_s" in e2e


def test_no_excluded_family_is_named():
    man = _man()
    texts = [json.dumps(man["configs"]), json.dumps(man["workloads"])]
    for c in man["configs"]:
        texts.append(json.dumps(spec.load_config(c["name"])))
    for w in man["workloads"]:
        texts.append(json.dumps(spec.load_workload(w["name"])))
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    open_q = perf.split("## 7. Open questions", 1)[-1]
    texts += [line for line in open_q.splitlines() if line.startswith("|")]
    hits = [t[:80] for t in texts if EXCLUDED.search(t)]
    assert not hits, hits


def test_the_model_comes_from_the_cell_file_alone():
    """Neither the serve CLI's defaults nor the smoke-width configs reach a
    run: the harness builds the config from the cell's configuration file."""
    banned = {"repro_torch.launch", "repro_torch.launch.serve", "repro_torch.configs"}
    for name in ("run.py", "harness.py", "inputs.py", "spec.py", "traffic.py"):
        with open(os.path.join(BENCH, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert node.module not in banned, (name, node.module)
            elif isinstance(node, ast.Import):
                assert not {a.name for a in node.names} & banned, name
            elif isinstance(node, ast.Attribute):
                assert node.attr not in ("reduced", "get_config"), name
            elif isinstance(node, ast.Name):
                assert node.id not in ("reduced", "get_config"), name
