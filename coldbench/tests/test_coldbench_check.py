"""The check that decides ``correct``: the reference agrees with the port,
sound runs pass, and the control and every fault the cells can have fail."""

import json

import pytest
import torch

from conftest import DATA

import control
import harness
import inputs
import spec
import traffic
from reference import logit_gap


def _tiny(name, **over):
    from repro_torch.models.config import ModelConfig

    cfgd = dict(spec.load_config(name, DATA), **over)
    return cfgd, ModelConfig(name=cfgd["name"], **spec.model_fields(cfgd))


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-ssm", "tiny-hybrid"])
def test_reference_matches_the_port_in_float32(name):
    from repro_torch.models import Batch, Model
    from repro_torch.models.transformer import build_params

    cfgd, cfg = _tiny(name, dtype="float32")
    tree = inputs.make_base(build_params, cfg, 3, torch.device("cpu"))
    toks = torch.from_numpy(traffic.tokens(cfg.vocab_size, 2, 96, 5))
    with torch.no_grad():
        port = Model(cfg).logits(tree, Batch(tokens=toks))[:, -1]
    ref = spec.load_model(name, DATA).Reference(cfgd).last_logits(inputs.flatten(tree), toks)
    assert logit_gap(port.numpy(), ref) < 1e-4
    assert logit_gap(port[:, :8].numpy(), ref) < 1e-4


@pytest.mark.parametrize("cell", ["tiny-dense.cold", "tiny-ssm.warm", "tiny-hybrid.warm"])
def test_sound_runs_pass_and_the_float8_control_fails(cell):
    out = harness.run_cell(cell, 77, 1.0, False, device="cpu", base=DATA)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    # every function's cold start in set-up is compared, besides the window's sample
    n_fn = len(spec.load_workload(cell, DATA)["functions"])
    assert out["compared"]["cold"] >= n_fn and out["compared"]["warm"] > 0
    limit = spec.load_workload(cell, DATA)["check"]["logit_err"]
    gap, n = control.control_gap(cell, 77, "cpu", base=DATA)
    assert n == spec.load_workload(cell, DATA)["check"]["sample"]
    assert gap > limit > out["checks"]["logit_err"]["value"]


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        *head, leaf = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _wrap_fwd(cluster, cfgd, change):
    w = cluster.workers[0]
    inner = w._fwd[cfgd["name"]]
    w._fwd[cfgd["name"]] = lambda p, tokens: change(inner, p, tokens)


def token_altered(cluster, cfgd):
    def change(inner, p, tokens):
        t = tokens.clone()
        t[:, -1] = (t[:, -1] + 1) % cfgd["vocab_size"]
        return inner(p, t)
    _wrap_fwd(cluster, cfgd, change)


def half_the_batch(cluster, cfgd):
    def change(inner, p, tokens):
        h = inner(p, tokens[: tokens.shape[0] // 2])
        return torch.cat([h, h])
    _wrap_fwd(cluster, cfgd, change)


def restore_left_at_the_base(cluster, cfgd):
    w = cluster.workers[0]
    w._params_for = lambda spec_, inst, *a, **k: _unflatten(w._pool_dev[spec_.family])


@pytest.mark.parametrize("cell", ["tiny-dense.cold", "tiny-ssm.warm", "tiny-hybrid.warm"])
@pytest.mark.parametrize("fault", [token_altered, half_the_batch, restore_left_at_the_base])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    out = harness.run_cell(cell, 78, 1.0, False, device="cpu", base=DATA, tamper=fault)
    assert not out["correct"]
    c = out["checks"]["logit_err"]
    assert c["value"] > c["limit"]


def test_a_configuration_without_its_module_stops_before_set_up(tmp_path, monkeypatch):
    base = tmp_path / "bench"
    (base / "configs").mkdir(parents=True)
    (base / "workloads").mkdir()
    cfg = spec.load_config("tiny-ssm", DATA)
    (base / "configs" / "tiny-ssm.json").write_text(json.dumps(cfg))
    wl = spec.load_workload("tiny-ssm.warm", DATA)
    (base / "workloads" / "tiny-ssm.warm.json").write_text(json.dumps(wl))

    def no_set_up(*a, **k):
        raise AssertionError("set-up began")
    monkeypatch.setattr(inputs, "make_base", no_set_up)
    monkeypatch.setattr(harness, "_program", no_set_up)
    with pytest.raises(FileNotFoundError, match=r"configs/tiny-ssm\.py"):
        harness.run_cell("tiny-ssm.warm", 5, 1.0, False, device="cpu", base=str(base))
