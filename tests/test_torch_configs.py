"""The port's configuration registry equals the JAX package's, field by
field, for every architecture and its reduced smoke configuration."""

import dataclasses

import pytest
import torch

torch.set_num_threads(2)

from repro import configs as jcfg  # noqa: E402
from repro.models.blocks import build_plan as jax_plan  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.models.blocks import build_plan as port_plan  # noqa: E402

NAMES = list(jcfg.ARCHS) + ["faas_bench"]


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", NAMES)
def test_config_matches_jax(name, reduce):
    j, t = jcfg.get_config(name), tcfg.get_config(name)
    if reduce:
        j, t = jcfg.reduced(j), tcfg.reduced(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    jp, tp = jax_plan(j), port_plan(t)
    assert (tp.period, tp.n_repeat) == (jp.period, jp.n_repeat)
    assert [dataclasses.asdict(k) for k in tp.kinds] == [dataclasses.asdict(k) for k in jp.kinds]
    assert t.param_count() == j.param_count()


def test_registry_lists_and_aliases_match():
    assert tcfg.list_archs() == jcfg.list_archs()
    assert tcfg.ALIASES == jcfg.ALIASES
    assert tcfg.get_config("stablelm-3b").name == "stablelm-3b"
