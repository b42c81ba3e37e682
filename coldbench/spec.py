"""Find a cell's files by name and read them.

``BENCHMARK.json`` at the root names the cells and metrics; everything that
belongs to one configuration, one traffic mix or one per-layer metric lives
in a file of its own under this folder:

* ``configs/<config>.json``: the model's sizes as they are run, its source,
  ``reduced``, ``assumed`` and the deployment it stands for;
* ``configs/<config>.py``: the configuration's module, beside it:
  ``Reference`` (``Reference(cfg, quant=None)``, whose
  ``last_logits(P, tokens)`` gives the (b, V) float32 logits of every
  row's last position, in plain PyTorch, composed of ``reference.py``'s
  pieces), ``forward_flops(cfg, b, s)`` (the model FLOPs of one request's
  output) and ``kernel_calls(cfg, b, s)`` (for ``"flash_attention"`` and
  ``"ssd_scan"``, the (operations, bytes) of each call in one forward,
  from ``costs.py``; an empty list where the model makes no such call);
* ``workloads/<cell>.json``: the traffic mix of one cell;
* ``metrics/<metric>.py``: the reader of one per-layer metric, a module with
  ``read(ctx) -> float | None``, and ``SPANS = True`` where it reads the
  port's spans (``ctx.spans``), which turns the recorder on in a traced run.

Nothing here imports the program: the harness turns a configuration into
the program's own config type.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))

#: what a configuration file holds besides the program's config fields
CONFIG_META = ("name", "source", "reduced", "published", "assumed", "deployment",
               "param_count")


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def manifest(root: str) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_entry(man: Dict[str, Any], cell: str) -> Dict[str, Any]:
    for w in man["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in BENCHMARK.json")


def load_workload(cell: str, base: str = HERE) -> Dict[str, Any]:
    wl = load_json(os.path.join(base, "workloads", f"{cell}.json"))
    if wl.get("name") != cell:
        raise ValueError(f"workloads/{cell}.json names itself {wl.get('name')!r}")
    return wl


def load_config(name: str, base: str = HERE) -> Dict[str, Any]:
    cfg = load_json(os.path.join(base, "configs", f"{name}.json"))
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {cfg.get('name')!r}")
    return cfg


def model_fields(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The configuration's sizes and switches: every key but the metadata."""
    return {k: v for k, v in cfg.items() if k not in CONFIG_META}


def metrics_for(man: Dict[str, Any], cell: str, kind: str) -> List[Dict[str, Any]]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics: those without a
    ``workloads`` key, and those that list the cell."""
    return [m for m in man[kind] if "workloads" not in m or cell in m["workloads"]]


def _load(kind: str, name: str, path: str):
    mod_name = f"coldbench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_model(name: str, base: str = HERE):
    """The configuration's module, ``configs/<name>.py``."""
    path = os.path.join(base, "configs", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"configs/{name}.py is missing: a configuration brings its module "
            f"(Reference, forward_flops, kernel_calls) beside configs/{name}.json")
    return _load("config", name, path)


def load_metric(metric: str, base: str = HERE):
    """The reader's module, ``metrics/<metric>.py``."""
    return _load("metric", metric, os.path.join(base, "metrics", f"{metric}.py"))
