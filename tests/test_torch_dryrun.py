"""The port's dry run and cost model (``repro_torch.launch.{mesh,specs,dryrun}``,
``repro_torch.opcost``, ``repro_torch.roofline`` and the kernels' meta
route) against the JAX package's, on the CPU.

* Verbatim arithmetic: ``model_flops`` for every arch and cell, hlocost's
  ring factors ``_wire_bytes``, and the cell policy (``opt_for``,
  ``train_sharding``, ``microbatch_seqs``, ``remat_group_for``,
  ``dec_len``) equal JAX's; ``batch_structs`` / ``cache_structs`` have
  JAX's shapes and dtypes for every arch and cell.
* The meta route: flash attention (causal, window, prefix, Sk ≠ S, GQA) and
  the SSD scan, forward and backward, book one call each with their closed
  forms and launch nothing; a meta / CPU mix raises.  ``allowed_pairs``
  equals the count of a brute-force mask.
* Against JAX's compiles (subprocesses with 8 forced host devices and auto
  axes, each with its own timeout): the reduced prefill cells (seq 256,
  batch 8) on a 1×1 mesh within 1 % of ``repro.hlocost``'s FLOPs once the
  two conventions are reconciled in closed form (below), and
  ``argument_size_in_bytes`` of the three ``TestDryRunSmoke`` cells on the
  (4, 2) mesh exactly; those cells trace on meta (the port's counterpart
  of ``TestDryRunSmoke``), the train cell printing its FLOPs and wire bytes
  beside JAX's (recorded, not gated: the collectives are a stated model).
* Each collective rule against a one-leaf or one-layer closed form, a "pod"
  axis at InfiniBand rate; the CLI and the example as subprocesses on
  full-width production cells; ``make_host_mesh`` on one gloo rank.
* whisper's cross-attention under remat in bfloat16 (float32 encoder
  output, as JAX promotes) against JAX's loss.

The two FLOP conventions: at seq 256 ``blockwise_attention`` has one
block, XLA folds its skip ``cond`` away and hlocost counts the whole S × Sk
square of both products (4·b·nh·S·Sk·hd a layer), where the port books
the causal pairs (``fwd_cost``); and ``ssd_chunked``'s einsums take the
full c × c square of C·Bᵀ and of the scores (2c² per row pair), where the
``ssd_scan`` booking counts the causal half, c(c + 1)."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro import roofline as jax_roofline  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.hlocost import _wire_bytes as jax_wire_bytes  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.config import SHAPES as JAX_SHAPES  # noqa: E402
from repro_torch import opcost, roofline  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import params_from_flat  # noqa: E402
from repro_torch.distrib.sharding import AbstractMesh, P, Rules  # noqa: E402
from repro_torch.kernels import flash_attention as flash_pkg  # noqa: E402
from repro_torch.kernels import ssd as ssd_pkg  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_op  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    allowed_pairs,
    bwd_cost,
    fwd_cost,
)
from repro_torch.kernels.ssd import ssd_op  # noqa: E402
from repro_torch.kernels.ssd.kernel import bwd_cost as ssd_bwd_cost  # noqa: E402
from repro_torch.kernels.ssd.kernel import scan_cost  # noqa: E402
from repro_torch.launch import collectives, dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.config import SHAPES, LayerKind, cells_for  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
META = torch.device("meta")
SEQ, BATCH = 256, 8            # the reduced cells, as tests/test_launch.py sizes them
PREFILL_ARCHS = ["stablelm-3b", "olmoe-1b-7b", "mamba2-780m"]
SMOKE_CELLS = [("stablelm-3b", "train_4k"), ("olmoe-1b-7b", "decode_32k"),
               ("mamba2-780m", "long_500k")]


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _small(shape_name):
    return dataclasses.replace(SHAPES[shape_name], seq_len=SEQ, global_batch=BATCH)


def _port_cell(arch, shape_name, mesh_shape):
    cfg = reduced(get_config(arch))
    mesh = AbstractMesh(("data", "model"), mesh_shape)
    return specs.build_cell(cfg, _small(shape_name), mesh, loss_chunk=64)


# ------------------------------------------------------------ the JAX side

_JAX_CELLS = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
from repro import hlocost
from repro.configs import get_config, reduced
from repro.launch.specs import build_cell
from repro.models.config import SHAPES

out = {}
for arch, shape_name, mesh_shape in json.loads(sys.argv[1]):
    cfg = reduced(get_config(arch))
    shape = dataclasses.replace(SHAPES[shape_name], seq_len=256, global_batch=8)
    # GSPMD (auto) axes, which with_sharding_constraint accepts
    mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with mesh:
        cell = build_cell(cfg, shape, mesh, loss_chunk=64)
        compiled = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                           out_shardings=cell.out_shardings,
                           donate_argnums=cell.donate_argnums).lower(*cell.args).compile()
    t = hlocost.analyze_text(compiled.as_text())
    ma = compiled.memory_analysis()
    out[f"{arch}:{shape_name}:{mesh_shape[0]}x{mesh_shape[1]}"] = {
        "flops": t.flops, "wire_bytes": t.wire_bytes,
        "collective_counts": t.collective_counts,
        "argument_size_in_bytes": int(ma.argument_size_in_bytes)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    """hlocost's FLOPs and XLA's argument bytes of the reduced cells: the
    1×1 prefill cells and the (4, 2) smoke cells, two processes at once."""
    groups = [[(a, "prefill_32k", (1, 1)) for a in PREFILL_ARCHS],
              [(a, s, (4, 2)) for a, s in SMOKE_CELLS]]
    procs = [subprocess.Popen([sys.executable, "-c", _JAX_CELLS, json.dumps(g)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_env(), cwd=str(ROOT)) for g in groups]
    out = {}
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            raise
        assert p.returncode == 0, stderr[-3000:]
        out.update(json.loads(stdout.strip().splitlines()[-1]))
    return out


# ---------------------------------------------------- verbatim arithmetic

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equals_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name in cells_for(cfg):
        assert roofline.model_flops(cfg, SHAPES[name]) == \
            jax_roofline.model_flops(jcfg, JAX_SHAPES[name]), name


@pytest.mark.parametrize("op", opcost.COLLECTIVES)
def test_wire_bytes_equals_hlocost(op):
    for n in (2, 4, 8, 16):
        for nbytes in (1, 4096, 3 * 2**20 + 7):
            assert opcost._wire_bytes(op, nbytes, n) == jax_wire_bytes(op, nbytes, n)


def _tree(t):
    """path -> (shape, dtype name) of a nested dict of tensors or structs."""
    if isinstance(t, dict):
        return {f"{k}/{p}" if p else k: v for k, sub in t.items() for p, v in _tree(sub).items()}
    return {"": (tuple(t.shape), str(t.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_policy_and_structs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(specs.opt_for(cfg)) == dataclasses.asdict(jax_specs.opt_for(jcfg))
    assert specs.train_sharding(cfg) == jax_specs.train_sharding(jcfg)
    assert specs.microbatch_seqs(cfg) == jax_specs.microbatch_seqs(jcfg)
    assert specs.remat_group_for(cfg) == jax_specs.remat_group_for(jcfg)
    model, jmodel = build_model(cfg), jax_build(jcfg)
    for name in cells_for(cfg):
        B, S = SHAPES[name].global_batch, SHAPES[name].seq_len
        assert specs.dec_len(cfg, S) == jax_specs.dec_len(jcfg, S)
        for labels in (False, True):
            got = specs.batch_structs(cfg, B, S, labels=labels)
            assert all(t.device == META for t in got.values())
            assert _tree(got) == _tree(jax_specs.batch_structs(jcfg, B, S, labels=labels))
        got = specs.cache_structs(model, B, S)
        assert _tree(got) == _tree(jax_specs.cache_structs(jmodel, B, S)), name


# --------------------------------------------------------- the meta route

def _brute_pairs(S, Sk, causal, window, prefix_len):
    qp, kp = np.arange(S)[:, None], np.arange(Sk)[None, :]
    allowed = np.ones((S, Sk), bool)
    if causal:
        allowed &= (kp <= qp) | (kp < prefix_len)
    if window > 0:
        allowed &= qp - kp < window
    return int(allowed.sum())


def test_allowed_pairs_equals_the_mask():
    for S in (1, 5, 64, 130):
        for Sk in (1, 7, 64, 130, 200):
            for causal in (True, False):
                for window in (0, 1, 3, 64, 300):
                    for prefix in (0, 1, 40, 150):
                        kw = dict(causal=causal, window=window, prefix_len=prefix)
                        assert allowed_pairs(S, Sk, **kw) == _brute_pairs(S, Sk, causal, window,
                                                                          prefix), (S, Sk, kw)


def test_allowed_pairs_at_long_lengths_is_closed_form():
    """A 32k prefill and a 500k cache cost no memory."""
    S = 524288
    assert allowed_pairs(S, S, causal=True, window=0, prefix_len=0) == S * (S + 1) // 2
    assert allowed_pairs(S, S, causal=False, window=0, prefix_len=0) == S * S
    w = 4096
    assert allowed_pairs(S, S, causal=True, window=w, prefix_len=0) == \
        w * (w + 1) // 2 + (S - w) * w


class _Ledger:
    def __init__(self):
        self.calls = []

    def book_kernel(self, kernel, ops, nbytes):
        self.calls.append((kernel, ops, nbytes))


def _counts():
    return (flash_pkg.launches.value, flash_pkg.bwd_launches.value, ssd_pkg.launches.value,
            ssd_pkg.bwd_launches.value)


FLASH_CASES = {  # b, nh, nkv, S, Sk, hd, causal, window, prefix_len, dtype
    "causal": (2, 4, 4, 96, 96, 32, True, 0, 0, torch.bfloat16),
    "window": (1, 4, 4, 128, 128, 64, True, 40, 0, torch.bfloat16),
    "prefix": (1, 8, 1, 80, 80, 64, True, 0, 32, torch.float32),
    "sk_ne_s": (2, 4, 4, 24, 150, 32, False, 0, 0, torch.float32),
    "gqa": (1, 8, 2, 64, 64, 128, True, 0, 0, torch.bfloat16),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_meta_route_books_its_closed_forms(name):
    b, nh, nkv, S, Sk, hd, causal, window, prefix, dt = FLASH_CASES[name]
    q = torch.empty((b, S, nh, hd), dtype=dt, device=META, requires_grad=True)
    k, v = (torch.empty((b, Sk, nkv, hd), dtype=dt, device=META, requires_grad=True)
            for _ in "kv")
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    before = _counts()
    ledger = _Ledger()
    from repro_torch.kernels._launch import ledger_open
    with ledger_open(ledger):
        o = flash_attention_op(q, k, v, scale=hd ** -0.5, **kw)
        grads = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
        with torch.no_grad():
            o2 = flash_attention_op(q, k, v, scale=hd ** -0.5, **kw)
    assert o.shape == o2.shape == q.shape and o.device == META and o.dtype == dt
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    e = q.element_size()
    fwd = ("flash_attention", *fwd_cost(b, nh, nkv, S, Sk, hd, e, **kw))
    bwd = ("flash_attention_bwd", *bwd_cost(b, nh, nkv, S, Sk, hd, e, **kw))
    assert ledger.calls == [fwd, bwd, fwd]
    pairs = _brute_pairs(S, Sk, causal, window, prefix)
    assert fwd[1] == 4 * b * nh * pairs * hd and bwd[1] == 10 * b * nh * pairs * hd
    assert fwd[2] == (2 * b * S * nh + 2 * b * Sk * nkv) * hd * e
    assert bwd[2] == (4 * b * S * nh + 4 * b * Sk * nkv) * hd * e + 4 * b * nh * S
    assert _counts() == before


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_meta_route_books_its_closed_forms(dt):
    b, l, nh, hd, ds, chunk = 2, 512, 4, 64, 32, 128
    d_in = nh * hd
    xbc = torch.empty((b, l, d_in + 2 * ds), dtype=dt, device=META, requires_grad=True)
    x = xbc[..., :d_in].reshape(b, l, nh, hd)
    B, C = xbc[..., d_in:d_in + ds], xbc[..., d_in + ds:]
    dt_, A, D = (torch.empty(s, device=META, requires_grad=True)
                 for s in ((b, l, nh), (nh,), (nh,)))
    before = _counts()
    ledger = _Ledger()
    from repro_torch.kernels._launch import ledger_open
    with ledger_open(ledger):
        y, state = ssd_op(x, dt_, A, B, C, D, chunk=chunk)
        grads = torch.autograd.grad((y, state), (xbc, dt_, A, D),
                                    (torch.empty_like(y), torch.empty_like(state)))
    assert y.shape == x.shape and state.shape == (b, nh, hd, ds) and state.dtype == torch.float32
    assert [g.shape for g in grads] == [xbc.shape, dt_.shape, A.shape, D.shape]
    e = x.element_size()
    c, nc = chunk, l // chunk
    pairs = c * (c + 1) // 2
    assert ledger.calls == [("ssd_scan", *scan_cost(b, l, nh, hd, ds, chunk, e)),
                            ("ssd_scan_bwd", *ssd_bwd_cost(b, l, nh, hd, ds, chunk, e))]
    assert ledger.calls[0][1] == b * nc * (2 * pairs * ds + nh * (2 * pairs * hd + 4 * c * hd * ds))
    assert ledger.calls[0][2] == (2 * d_in + 2 * ds) * b * l * e + 4 * b * l * nh + 8 * nh \
        + 4 * b * nh * hd * ds
    assert ledger.calls[1][1] == b * nc * (2 * pairs * ds + nh * (
        2 * pairs * (2 * hd + 2 * ds) + 8 * c * hd * ds))
    assert _counts() == before


def test_meta_and_cpu_mix_raises():
    q = torch.empty((1, 8, 2, 16), device=META)
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="mixed"):
        flash_attention_op(q, k, k, scale=0.25)
    x = torch.empty((1, 8, 2, 16), device=META)
    with pytest.raises(ValueError, match="mixed"):
        ssd_op(x, torch.zeros(1, 8, 2), torch.zeros(2), torch.zeros(1, 8, 4),
               torch.zeros(1, 8, 4), torch.zeros(2), chunk=8)


def test_patch_and_int8_decode_have_no_meta_route():
    """The dry run reaches neither: on meta they refuse, as on the CPU's
    kernel wrappers."""
    from repro_torch.kernels.decode_attention import decode_attention_int8_op
    from repro_torch.kernels.snapshot_patch import patch_apply_op

    m = dict(device=META)
    with pytest.raises(ValueError, match="one CUDA device"):
        patch_apply_op(torch.empty((4, 8), **m), torch.empty((1, 8), **m),
                       torch.empty((4,), dtype=torch.int32, **m))
    kv = torch.empty((1, 16, 2, 32), dtype=torch.int8, **m)
    sc = torch.empty((1, 16, 2), **m)
    with pytest.raises(ValueError, match="one CUDA device"):
        decode_attention_int8_op(torch.empty((1, 4, 32), **m), kv, sc, kv, sc, 3, scale=0.2)


def test_meta_is_only_asked_for_by_name(monkeypatch):
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("meta") == META
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert build_model(reduced(get_config("stablelm-3b"))).init_cache(
        1, 4, device="meta")["pos0"]["k"].device == META


# ------------------------------------------------------- against JAX's compile

def _convention_gap(cfg):
    """hlocost's count less the port's, in closed form, at SEQ (one
    attention block) and BATCH: the attention square against the causal
    pairs, ssd_chunked's c × c squares against the booking's causal half."""
    b, S = BATCH, SEQ
    assert S <= 512  # one blockwise_attention block: hlocost counts the square
    gap = 0.0
    for kind in cfg_kinds(cfg):
        if kind.mixer == "attn":
            full = 4.0 * b * cfg.num_heads * S * S * cfg.head_dim
            gap += full - fwd_cost(b, cfg.num_heads, cfg.num_kv_heads, S, S, cfg.head_dim, 4,
                                   causal=True, window=0, prefix_len=0)[0]
        else:
            c = min(cfg.ssm_chunk, S)
            gap += b * (S // c) * (c * c - c) * (cfg.ssm_state + cfg.ssm_heads * cfg.ssm_head_dim)
    return gap


def cfg_kinds(cfg):
    from repro_torch.models.blocks import build_plan

    plan = build_plan(cfg)
    return [k for _ in range(plan.n_repeat) for k in plan.kinds]


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_flops_at_one_device_match_hlocost(arch, jax_cells):
    cell = _port_cell(arch, "prefill_32k", (1, 1))
    _, totals, _, colls = dryrun.trace_cell(cell)
    want = jax_cells[f"{arch}:prefill_32k:1x1"]["flops"]
    got = totals.flops + _convention_gap(cell.cfg)
    print(f"{arch} prefill 1x1: port {totals.flops:.6g} (+{_convention_gap(cell.cfg):.6g} "
          f"conventions) vs hlocost {want:.6g}")
    assert abs(got - want) <= 0.01 * want, (got, want)
    assert colls == [] and set(totals.devices) == {"meta"}


@pytest.mark.parametrize("arch,shape_name", SMOKE_CELLS, ids=[f"{a}-{s}" for a, s in SMOKE_CELLS])
def test_smoke_cell_traces_on_meta_with_jax_argument_bytes(arch, shape_name, jax_cells):
    """The port's counterpart of ``TestDryRunSmoke``: the cell traces on
    meta with FLOPs > 0, and its argument bytes per device equal XLA's."""
    cell = _port_cell(arch, shape_name, (4, 2))
    outputs, totals, read, colls = dryrun.trace_cell(cell)
    assert totals.flops > 0 and set(totals.devices) == {"meta"}
    mem = dryrun.memory_report(cell, outputs, read, totals.peak_live_bytes, 8)
    want = jax_cells[f"{arch}:{shape_name}:4x2"]
    assert mem["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    per_dev = totals.per_device(8, colls)
    print(f"{arch} {shape_name} (4, 2): FLOPs/device port {per_dev.flops:.6g} JAX "
          f"{want['flops']:.6g} (ratio {per_dev.flops / want['flops']:.4f}); wire bytes "
          f"port {per_dev.wire_bytes:.6g} JAX {want['wire_bytes']:.6g}; collectives port "
          f"{per_dev.collective_counts} JAX {want['collective_counts']}")


def test_moe_serving_cell_flops_per_device_match_jax(jax_cells):
    """olmoe-1b-7b ``decode_32k`` on (4, 2) is served TP-only: JAX's
    ``moe_ffn_sharded`` routes the whole batch on each of the 4 data
    shards, and the port's global step books that (``global_moe_ffn``).
    FLOPs a device within 1 % of JAX's."""
    cell = _port_cell("olmoe-1b-7b", "decode_32k", (4, 2))
    assert cell.rules.wf is None  # the serving layout
    _, totals, _, _ = dryrun.trace_cell(cell)
    want = jax_cells["olmoe-1b-7b:decode_32k:4x2"]["flops"]
    assert abs(totals.flops / 8 - want) <= 0.01 * want, (totals.flops / 8, want)


# ---------------------------------------------------------- collective rules

MESH = AbstractMesh(("data", "model"), (4, 2))


def test_fsdp_gather_rule_one_leaf():
    L, D, F = 3, 64, 32
    shapes = {"blocks": {"pos0": {"w": torch.empty((L, D, F), dtype=torch.bfloat16,
                                                   device=META)}},
              "embed": {"table": torch.empty((128, D), device=META)}}
    specs_ = {"blocks": {"pos0": {"w": P(None, ("data",), "model")}},
              "embed": {"table": P("model", ("data",))}}
    got = collectives.fsdp_gathers(shapes, specs_, MESH, ("data",), block_passes=2, microbatches=3)
    layer = L * D * F * 2 // 2 // L   # one layer's slice, gathered over data, model-sharded
    table = 128 * D * 4 // 2
    assert [(c.op, c.axes, c.group, c.nbytes, c.count) for c in got] == [
        ("all-gather", ("data",), 4, layer, L * 2 * 3), ("all-gather", ("data",), 4, table, 3)]
    assert got[0].wire_bytes == layer * 3 / 4 * L * 2 * 3


def test_gradient_reduction_rule_one_leaf():
    shapes = {"w": torch.empty((64, 32), device=META), "scale": torch.empty((64,), device=META)}
    specs_ = {"w": P(("data",), "model"), "scale": P()}
    got = collectives.grad_reductions(shapes, specs_, MESH, ("data",), ("data",), microbatches=2)
    assert [(c.what, c.op, c.axes, c.nbytes, c.count) for c in got] == [   # sorted paths
        ("scale", "all-reduce", ("data",), 64 * 4, 2),
        ("w", "reduce-scatter", ("data",), 64 * 32 * 4 // 8, 2)]
    assert got[0].wire_bytes == 2 * 64 * 4 * 3 / 4 * 2
    assert got[1].wire_bytes == 64 * 32 * 4 // 8 * 3 * 2


@pytest.mark.parametrize("arch,kind,want", [
    ("stablelm-3b", LayerKind("attn", "mlp"), ["tp all-reduce", "tp all-reduce"]),
    ("olmoe-1b-7b", LayerKind("attn", "moe"), ["tp all-reduce", "moe combine"]),
    ("mamba2-780m", LayerKind("mamba", "none"), ["tp all-reduce"]),
])
def test_layer_all_reduce_rule_one_layer(arch, kind, want):
    cfg = reduced(get_config(arch))
    rules = Rules(MESH)
    t = 100
    got = collectives.layer_all_reduces(cfg, rules, tokens=t, passes=2, backward=True,
                                   layers=[("l0", kind)], microbatches=2)
    assert [c.rule for c in got] == want
    for c in got:
        e = 2 if c.rule == "moe combine" else 4  # bf16 combine; reduced configs are f32
        assert (c.op, c.axes, c.group, c.nbytes, c.count) == (
            "all-reduce", ("model",), 2, t * cfg.d_model * e, 3 * 2)
        assert c.wire_bytes == 2 * t * cfg.d_model * e / 2 * 6
    assert collectives.layer_all_reduces(cfg, Rules(AbstractMesh(("data", "model"), (8, 1))),
                                    tokens=t, passes=1, backward=False,
                                    layers=[("l0", kind)]) == []


def test_cache_combine_rule_one_layer():
    cfg = reduced(get_config("jamba-v0.1-52b"))
    rules = Rules(MESH)
    layers = [("l0", LayerKind("attn", "mlp")), ("l1", LayerKind("mamba", "mlp"))]
    got = collectives.cache_combines(cfg, rules, batch=1, layers=layers)
    heads = cfg.num_heads // 2 if cfg.num_heads % 2 == 0 else cfg.num_heads
    assert [(c.what, c.op, c.axes, c.nbytes) for c in got] == [
        ("l0", "all-reduce", ("data",), heads * (cfg.head_dim + 2) * 4)]
    assert collectives.cache_combines(cfg, rules, batch=8, layers=layers) == []


def test_pod_axis_is_costed_at_infiniband_rate():
    pod = collectives.Collective("fsdp gather", "w", "all-gather", ("pod", "data"), 32, 2**20, 1)
    data = dataclasses.replace(pod, axes=("data",), group=16)
    assert roofline.collective_seconds([pod]) == pod.wire_bytes / roofline.IB_BW
    assert roofline.collective_seconds([data]) == data.wire_bytes / roofline.NVLINK_BW
    assert roofline.axis_rate(("pod", "data", "model")) == 50e9
    assert roofline.axis_rate(("model",)) == 450e9


def test_remat_passes_of_the_rules_are_the_traced_ones():
    """Rule 1's passes a microbatch are the forwards the trace books:
    flash forward calls = layers × passes × microbatches."""
    cfg = reduced(get_config("stablelm-3b"))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64, global_batch=32)
    cell = specs.build_cell(cfg, shape, MESH, loss_chunk=32)
    _, totals, _, colls = dryrun.trace_cell(cell)
    assert cell.microbatches == 2
    layers = cfg.num_layers
    assert totals.kernel_calls == {"flash_attention": layers * 2 * 2,
                                   "flash_attention_bwd": layers * 2}
    wq = [c for c in colls if c.what == "blocks/pos0/wq"]
    assert [(c.rule, c.count) for c in wq] == [("fsdp gather", layers * 2 * 2),
                                               ("gradient reduction", 2)]


def test_roofline_terms_use_the_h100_constants():
    colls = [collectives.Collective("tp all-reduce", "l0", "all-reduce", ("model",), 2,
                                    450 * 10**9, 1)]
    t = opcost.CostTotals(flops=989e12, bytes=3.35e12)
    t.add_collectives(colls)
    cfg = get_config("stablelm-3b")
    terms = roofline.analyze(arch=cfg.name, shape_name="train_4k", mesh_name="m", n_devices=1,
                             totals=t, dtype="bfloat16", collectives=colls, cfg=cfg,
                             shape=SHAPES["train_4k"])
    assert (terms.t_compute, terms.t_memory, terms.t_collective) == (1.0, 1.0, 1.0)
    assert roofline.analyze(arch="a", shape_name="s", mesh_name="m", n_devices=1, totals=t,
                            dtype="float32").t_compute == 989 / 67
    assert set(roofline.to_json(terms)) == {
        f.name for f in dataclasses.fields(jax_roofline.RooflineTerms)}


# ---------------------------------------------------------- CLI and example

JAX_KEYS = {"arch", "shape", "mesh", "n_devices", "ok", "t_lower_s", "t_compile_s",
            "memory_analysis", "cost_analysis", "roofline", "hlo_bytes"}


def _check_artifact(path, arch, shape_name, mesh_name, n):
    d = json.loads(path.read_text())
    assert set(d) == (JAX_KEYS - {"t_lower_s", "t_compile_s", "hlo_bytes"}) | {"t_trace_s",
                                                                               "opcost"}
    assert (d["arch"], d["shape"], d["mesh"], d["n_devices"], d["ok"]) == (
        arch, shape_name, mesh_name, n, True)
    assert set(d["roofline"]) == {f.name for f in dataclasses.fields(jax_roofline.RooflineTerms)}
    mem = d["memory_analysis"]
    assert mem["live_bytes_per_device"] == (mem["argument_size_in_bytes"]
                                            + mem["output_size_in_bytes"]
                                            - mem["alias_size_in_bytes"]
                                            + mem["temp_size_in_bytes"])
    assert d["roofline"]["flops_per_device"] > 0 and set(d["opcost"]["devices"]) == {"meta"}
    return d


def test_cli_writes_the_artifacts_of_both_meshes(tmp_path):
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "gemma-2b",
                        "--shape", "prefill_32k", "--both-meshes", "--out", str(tmp_path)],
                       capture_output=True, text=True, env=_env(CUDA_VISIBLE_DEVICES=""),
                       cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [x for x in r.stdout.splitlines() if x.startswith("[dryrun] gemma-2b")]
    assert len(lines) == 2 and all("Tc=" in x and "trace=" in x for x in lines)
    one = _check_artifact(tmp_path / "gemma-2b__prefill_32k__pod16x16.json", "gemma-2b",
                          "prefill_32k", "pod16x16", 256)
    two = _check_artifact(tmp_path / "gemma-2b__prefill_32k__pod2x16x16.json", "gemma-2b",
                          "prefill_32k", "pod2x16x16", 512)
    # twice the devices, half the FLOPs of each
    assert two["roofline"]["flops_per_device"] == one["roofline"]["flops_per_device"] / 2
    assert one["opcost"]["kernel_calls"] == {"flash_attention": get_config("gemma-2b").num_layers}


def test_example_runs_without_a_gpu(tmp_path):
    r = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_multipod_dryrun.py"),
                        "mamba2-780m", "decode_32k", "--out", str(tmp_path)],
                       capture_output=True, text=True, env=_env(CUDA_VISIBLE_DEVICES=""),
                       cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    for mesh, n in (("pod16x16", 256), ("pod2x16x16", 512)):
        _check_artifact(tmp_path / f"mamba2-780m__decode_32k__{mesh}.json", "mamba2-780m",
                        "decode_32k", mesh, n)


def test_production_meshes_are_jax_s():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.axis_sizes) == (("data", "model"), (16, 16))
    assert (two.axis_names, two.axis_sizes) == (("pod", "data", "model"), (2, 16, 16))


def test_host_mesh_over_one_gloo_rank(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(device="cpu")
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


# ------------------------------------------- whisper's cross-attention in bf16

#: a gradient leaf's largest error against JAX's, over its largest entry: the
#: bfloat16 tolerance of tests/test_torch_flash.py and tests/test_torch_ssd.py
GRAD_TOL_BF16 = 2e-2
#: the port's cross-attention broken on purpose: left in bf16 (the encoder's
#: output cast down), zeroed cross keys, zeroed cross values
WHISPER_FAULTS = ("bf16_cross_attention", "zero_cross_keys", "zero_cross_values")


def _whisper_batch(cfg):
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
    frames = (rng.standard_normal((2, 32, cfg.d_model)) * 0.02).astype(np.float32)
    return tokens, frames


def _cross_dtypes(calls):
    """(k, v, compute) dtype names of the cross-attention calls (Sk ≠ S;
    the encoder's self-attention has Sk = S): compute is what q, k and v
    promote to."""
    return sorted({(str(k).split(".")[-1], str(v).split(".")[-1],
                    str(jnp.result_type(*(str(d).split(".")[-1] for d in (q, k, v)))))
                   for q, k, v, s, sk in calls if s != sk})


@pytest.fixture(scope="module")
def whisper_jax():
    """JAX's bf16 remat step of reduced whisper: loss, every gradient leaf
    (``jax.value_and_grad``) and the dtypes of its cross-attention."""
    import repro.models.transformer as jax_transformer
    from repro.core.snapshot import flatten_pytree
    from repro.models import Batch as JBatch

    jcfg = dataclasses.replace(jax_reduced(jax_config("whisper-small")), dtype="bfloat16")
    jm = jax_build(jcfg, remat=True)
    jparams = jm.init(0)
    tokens, frames = _whisper_batch(jcfg)
    batch = JBatch(tokens=jnp.asarray(tokens), labels=jnp.asarray(tokens),
                   prefix_embeds=jnp.asarray(frames, jnp.bfloat16))
    calls, inner = [], jax_transformer.blockwise_attention

    def recorded(q, k, v, **kw):
        calls.append((q.dtype, k.dtype, v.dtype, q.shape[1], k.shape[1]))
        return inner(q, k, v, **kw)

    jax_transformer.blockwise_attention = recorded
    try:
        loss, grads = jax.value_and_grad(lambda p: jm.loss(p, batch))(jparams)
    finally:
        jax_transformer.blockwise_attention = inner
    return {"params": flatten_pytree(jax.tree.map(np.asarray, jparams)), "loss": float(loss),
            "grads": flatten_pytree(jax.tree.map(np.asarray, grads)),
            "cross": _cross_dtypes(calls)}


def _whisper_port_mismatches(want, fault=None):
    """The port's bf16 remat step of reduced whisper, with ``fault`` (one
    of ``WHISPER_FAULTS``) or none, against ``want``: the names of what
    disagrees ("loss", "cross dtypes", or a gradient leaf's path)."""
    import repro_torch.models.transformer as transformer
    from repro_torch.convert import params_to_flat
    from repro_torch.launch.steps import value_and_grad

    tcfg = dataclasses.replace(reduced(get_config("whisper-small")), dtype="bfloat16")
    tm = build_model(tcfg, remat=True)
    params = params_from_flat(want["params"], "cpu", template=tm.param_shapes())
    if fault == "bf16_cross_attention":
        encode = tm._encode
        tm._encode = lambda p, f: encode(p, f).to(torch.bfloat16)
    elif fault in ("zero_cross_keys", "zero_cross_values"):
        leaf = "ck" if fault == "zero_cross_keys" else "cv"
        params["blocks"]["pos0"][leaf] = torch.zeros_like(params["blocks"]["pos0"][leaf])
    tokens, frames = _whisper_batch(tcfg)
    calls, inner = [], transformer.flash_attention_op

    def recorded(q, k, v, **kw):
        calls.append((q.dtype, k.dtype, v.dtype, q.shape[1], k.shape[1]))
        return inner(q, k, v, **kw)

    transformer.flash_attention_op = recorded
    try:
        loss, grads = value_and_grad(tm, params, {
            "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(tokens),
            "prefix_embeds": torch.from_numpy(frames).to(torch.bfloat16)})
    finally:
        transformer.flash_attention_op = inner
    bad = []
    if abs(float(loss) - want["loss"]) > 2e-2 * abs(want["loss"]):
        bad.append("loss")
    if _cross_dtypes(calls) != want["cross"]:
        bad.append("cross dtypes")
    assert grads["blocks"]["pos0"]["ck"].dtype == torch.bfloat16
    got = params_to_flat(torch.utils._pytree.tree_map(lambda t: t.float(), grads))
    assert sorted(got) == sorted(want["grads"])
    for path, w in want["grads"].items():
        w, g = np.asarray(w, np.float64), np.asarray(got[path], np.float64)
        assert g.shape == w.shape, path
        if not (np.max(np.abs(g - w)) <= GRAD_TOL_BF16 * np.max(np.abs(w))):
            bad.append(path)  # a NaN fails too
    return bad


def test_whisper_bf16_remat_loss_matches_jax(whisper_jax):
    """Under remat the encoder's output is float32: JAX promotes the cross
    keys and values (and the attention) to float32; the port does the same
    (before, its einsum refused the bf16 weights).  The loss within 2e-2,
    every gradient leaf (cq, ck, cv, co, the encoder's blocks, ...) within
    ``GRAD_TOL_BF16`` of its largest entry, and the cross-attention's k, v
    and compute dtypes equal to JAX's."""
    assert whisper_jax["cross"] == [("float32", "float32", "float32")]
    assert _whisper_port_mismatches(whisper_jax) == []


@pytest.mark.parametrize("fault,caught", [
    ("bf16_cross_attention", "cross dtypes"),
    ("zero_cross_keys", "blocks/pos0/cq"),
    ("zero_cross_values", "blocks/pos0/co"),
])
def test_whisper_check_fails_a_wrong_cross_attention(whisper_jax, fault, caught):
    """Controls: the check above refuses a cross-attention left in bf16 (by
    its dtypes: its gradients agree with JAX's to bf16's own rounding),
    and zeroed cross keys or values (by their gradients)."""
    assert caught in _whisper_port_mismatches(whisper_jax, fault)


# ------------------------------------------- the MoE FFN of a cell's global step

@pytest.mark.parametrize("weight_fsdp", [False, True], ids=["serving", "training"])
def test_global_moe_ffn_books_the_sharded_token_layout(weight_fsdp):
    """On a (4, 2) mesh, one MoE layer of the global step books per device
    what one rank of ``moe_ffn_sharded`` computes: the serving layout (no
    FSDP axes) routes the whole batch in one group on each of the 4 data
    replicas, the training layout routes each FSDP shard's tokens as a
    group, once.  FLOPs in closed form: the float32 router and the expert
    products over every slot."""
    from repro_torch.distrib.act import default_rules, logical_axis_rules
    from repro_torch.models import moe

    cfg = reduced(get_config("olmoe-1b-7b"))
    b, s, D = 8, 16, cfg.d_model
    E, K, F = cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_d_ff
    params = {"router": torch.empty((D, E), device=META),
              **{n: torch.empty((E, D, F) if n != "w_out" else (E, F, D), device=META)
                 for n in (("w_in", "w_gate", "w_out") if cfg.mlp_gated else ("w_in", "w_out"))}}
    x = torch.empty((b, s, D), device=META)
    rules = default_rules(MESH, cfg, batch=b, weight_fsdp=weight_fsdp)
    with logical_axis_rules(MESH, rules), moe.routed(specs.global_moe_ffn):
        _, totals, _ = opcost.trace(lambda: specs.global_moe_ffn(params, x, cfg))
    groups, rep = (4, 1) if weight_fsdp else (1, 4)
    t = b * s
    C = max(1, int(cfg.capacity_factor * (t // groups) * K / E))
    mats = 3 if cfg.mlp_gated else 2
    assert totals.flops == rep * (2 * t * D * E + mats * 2 * groups * E * C * D * F)


def test_global_moe_ffn_refuses_replicas_under_autograd():
    from repro_torch.distrib.act import default_rules, logical_axis_rules

    cfg = reduced(get_config("olmoe-1b-7b"))
    x = torch.empty((8, 4, cfg.d_model), device=META, requires_grad=True)
    with logical_axis_rules(MESH, default_rules(MESH, cfg, batch=8, weight_fsdp=False)):
        with pytest.raises(NotImplementedError, match="4 replicas"):
            specs.global_moe_ffn({}, x, cfg)
