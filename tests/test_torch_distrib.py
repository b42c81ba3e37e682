"""The port's distribution layer (``repro_torch.distrib``, ``moe_ffn_sharded``,
``optim.opt_state_specs``) against the JAX package's.

* Spec trees: ``Rules`` (param / cache / batch specs), ``default_rules``
  and ``opt_state_specs`` equal JAX's, as tuples, for every arch and
  faas-bench, on a (4, 2) ("data", "model") and a (2, 2, 2) ("pod",
  "data", "model") mesh, in both weight layouts.
* Four gloo ranks on the CPU, spawned once for the module (this file run
  as a script with ``--rank``), beside one JAX process on four host
  devices (``--jax``): DTensor placements against
  ``NamedSharding.devices_indices_map``; ``moe_ffn_sharded`` (EP, TP, the
  int8 gather, gated and ungated, bf16, two FSDP axes, the serving
  layout, the fallback) against JAX's; ``ef_compressed_mean`` against
  JAX's; and the controls that must fail (EP ownership one rank off, the
  combine in float32, the error-feedback residual dropped).
* ``shard`` leaves the forward bit-equal outside a binding, and under one
  the MoE layers take ``moe_ffn_sharded``.

Tolerances: float32 expert outputs are combined in bf16 (as JAX does), so
y is held to JAX within one bf16 ulp (rtol 2^-7) with at least 95 % of
the elements bit-equal over two "model" ranks; over four, gloo rounds
the bf16 sum at every hop where XLA's CPU psum adds in float32 and rounds
once (rtol 2^-7, atol 2^-7 · max|y|; with the sum taken so, 95 %
bit-equal); bf16 experts as ``tests/test_torch_moe.py`` holds them
(atol 3e-2 · max|y|); the fallback, float32 throughout, at 1e-5.  Against
the unsharded ``moe_ffn``: bf16 rounding of the sum (rtol 2^-7, atol
2^-7 · max|y|).  aux within 1e-6 relative; the error-feedback mean within
2 ulp of JAX's, its error buffer bit-equal.
"""

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).resolve()
ROOT = HERE.parents[1]
SRC = ROOT / "src"

S, D, F = 8, 64, 32
CF = 1.0  # drops at this size: dropped choices must reach no expert
MOE_CASES = {
    "ep": dict(mesh=(2, 2), names=("data", "model"), E=8, K=2, b=4),
    "ep_ungated": dict(mesh=(2, 2), names=("data", "model"), E=8, K=2, b=4,
                       gated=False, act="gelu"),
    "ep_int8": dict(mesh=(2, 2), names=("data", "model"), E=8, K=2, b=4, int8=True),
    "ep_bf16": dict(mesh=(2, 2), names=("data", "model"), E=8, K=2, b=4, dtype="bfloat16"),
    "ep_pod": dict(mesh=(2, 1, 2), names=("pod", "data", "model"), E=4, K=2, b=4),
    "fsdp_two_axes": dict(mesh=(2, 2, 1), names=("pod", "data", "model"), E=4, K=2, b=4),
    "tp": dict(mesh=(1, 4), names=("data", "model"), E=2, K=1, b=2),
    "tp_ungated": dict(mesh=(1, 4), names=("data", "model"), E=2, K=1, b=2,
                       gated=False, act="gelu"),
    "tp_int8": dict(mesh=(2, 2), names=("data", "model"), E=3, K=1, b=4, int8=True),
    "fallback": dict(mesh=(2, 2), names=("data", "model"), E=8, K=2, b=3),
    # the serving layout (weight_fsdp=False): the tokens of every batch
    # shard are routed together, C from all of them
    "ep_serving": dict(mesh=(2, 2), names=("data", "model"), E=8, K=2, b=4, fsdp=False),
    "tp_serving": dict(mesh=(2, 2), names=("data", "model"), E=3, K=1, b=4, fsdp=False),
}
EP_CASES = [n for n, c in MOE_CASES.items()
            if n != "fallback" and c["E"] % c["mesh"][-1] == 0 and c["mesh"][-1] > 1]
F32_CASES = [n for n, c in MOE_CASES.items()
             if n != "fallback" and c.get("dtype", "float32") == "float32"]

# (spec, shape) on a (2, 2) ("data", "model") mesh
PLACEMENT_CASES = [
    ((), (4, 6)),
    (("data",), (4, 6)),
    ((None, "model"), (4, 6)),
    (("data", "model"), (4, 6)),
    (("model", "data"), (4, 6)),
    ((("data", "model"), None), (8, 2)),
    ((None, ("data", "model")), (2, 8)),
    ((None, "model", "data"), (3, 4, 2)),
    ((("data", "model"),), (4,)),
]
EF_SHAPE = (64, 32)


def _moe_cfg(ModelConfig, case):
    return ModelConfig(
        name="moe-t", family="moe", num_layers=1, d_model=D, num_heads=2,
        num_kv_heads=2, d_ff=F, vocab_size=64, num_experts=case["E"],
        num_experts_per_tok=case["K"], moe_d_ff=F, capacity_factor=CF,
        mlp_gated=case.get("gated", True), hidden_act=case.get("act", "silu"),
        moe_int8_gather=case.get("int8", False), dtype=case.get("dtype", "float32"))


def _moe_inputs(name):
    case = MOE_CASES[name]
    rng = np.random.default_rng(list(MOE_CASES).index(name))
    E = case["E"]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"router": f(D, E), "w_in": f(E, D, F) * 0.2, "w_gate": f(E, D, F) * 0.2,
            "w_out": f(E, F, D) * 0.2, "x": f(case["b"], S, D)}


def _ef_parts():
    return np.random.default_rng(0).standard_normal((4,) + EF_SHAPE).astype(np.float32)


# ------------------------------------------------------------ the JAX side

def _jax_main(out: pathlib.Path) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

    from repro.distrib.act import default_rules, logical_axis_rules
    from repro.distrib.compress import ef_compressed_mean
    from repro.models.config import ModelConfig
    from repro.models.moe import moe_ffn_sharded

    def make_mesh(shape, names):  # GSPMD (auto) axes, as the launch layer binds them
        return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

    arrays, meta = {}, {"place": []}
    mesh = make_mesh((2, 2), ("data", "model"))
    for spec, shape in PLACEMENT_CASES:
        m = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
        meta["place"].append({str(d.id): [list(sl.indices(n)[:2]) for sl, n in zip(idx, shape)]
                              for d, idx in m.items()})
    for name, case in MOE_CASES.items():
        mesh = make_mesh(case["mesh"], case["names"])
        cfg = _moe_cfg(ModelConfig, case)
        dt = jnp.dtype(cfg.dtype)
        inp = _moe_inputs(name)
        params = {k: jnp.asarray(inp[k], jnp.float32 if k == "router" else dt)
                  for k in ("router", "w_in", "w_gate", "w_out")}
        x = jnp.asarray(inp["x"], dt)
        rules = default_rules(mesh, cfg, batch=case["b"], weight_fsdp=case.get("fsdp", True))
        with logical_axis_rules(mesh, rules):
            y, aux = jax.jit(lambda p, x: moe_ffn_sharded(p, x, cfg, capacity_factor=CF))(
                params, x)
        arrays[f"moe/{name}/y"] = np.asarray(y.astype(jnp.float32))
        arrays[f"moe/{name}/aux"] = np.asarray(aux)
    mesh = make_mesh((4,), ("pod",))
    parts = jnp.asarray(_ef_parts())
    mean, err = ef_compressed_mean(parts, jnp.zeros_like(parts), mesh, "pod")
    arrays["ef/mean"], arrays["ef/err"] = np.asarray(mean), np.asarray(err)
    np.savez(out / "jax.npz", **arrays)
    (out / "jax.json").write_text(json.dumps(meta))


# ---------------------------------------------------------- the port's side

def _rank_main(rank: int, world: int, init: str, out: pathlib.Path) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from repro_torch.configs import get_config, reduced
    from repro_torch.distrib import act, sharding
    from repro_torch.distrib.compress import ef_compressed_mean
    from repro_torch.models import Batch, build_model, moe, transformer
    from repro_torch.models.config import LayerKind, ModelConfig

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    res = {}
    P = sharding.PartitionSpec

    def local(mesh, spec, a):
        return a[sharding.local_slices(mesh, spec, a.shape, mesh.get_coordinate())]

    all_reduce = dist.all_reduce

    def f32_wire(t, group=None):
        if t.dtype != torch.bfloat16:
            return all_reduce(t, group=group)
        w = t.float()
        all_reduce(w, group=group)
        t.copy_(w.to(torch.bfloat16))

    # placements: which index of the whole tensor each rank holds
    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for i, (spec, shape) in enumerate(PLACEMENT_CASES):
        whole = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        loc = distribute_tensor(whole, mesh22, sharding.placements(mesh22, P(*spec))).to_local()
        start = np.unravel_index(int(loc.reshape(-1)[0]), shape)
        res[f"place/{i}"] = np.array([[s0, s0 + n] for s0, n in zip(start, loc.shape)])
        res[f"place_local/{i}"] = np.array(
            [[s.start, s.stop] for s in sharding.local_slices(
                mesh22, P(*spec), shape, mesh22.get_coordinate())])

    # shard() on a DTensor: to the mapped placements, replication where a
    # dim does not divide
    rules = {"batch": "data", "embed": "model"}
    with act.logical_axis_rules(mesh22, rules):
        x = distribute_tensor(torch.arange(24.).reshape(4, 6), mesh22, [Replicate(), Replicate()])
        y = act.shard(x, "batch", "embed")
        res["shard/placements"] = np.array([str(p) for p in y.placements])
        res["shard/local"] = y.to_local().numpy()
        z = act.shard(distribute_tensor(torch.zeros(3, 5), mesh22, [Replicate(), Replicate()]),
                      "batch", "embed")
        res["shard/odd"] = np.array([str(p) for p in z.placements])
        plain = torch.ones(4, 6)
        res["shard/plain_is_same"] = np.array(act.shard(plain, "batch", "embed") is plain)
        res["shard/is_dtensor"] = np.array(isinstance(y, DTensor))

    for name, case in MOE_CASES.items():
        mesh = init_device_mesh("cpu", case["mesh"], mesh_dim_names=case["names"])
        cfg = _moe_cfg(ModelConfig, case)
        dt = getattr(torch, cfg.dtype)
        inp = _moe_inputs(name)
        wf = case.get("fsdp", True)
        rules = act.default_rules(mesh, cfg, batch=case["b"], weight_fsdp=wf)
        specs = sharding.Rules(mesh, weight_fsdp=wf).layer_specs(
            cfg, LayerKind("attn", "moe"), False)["ffn"]
        params = {k: torch.from_numpy(local(mesh, specs[k], inp[k])).to(
            torch.float32 if k == "router" else dt) for k in specs}
        xs = sharding.local_slices(mesh, P(rules["batch"], None, None), inp["x"].shape,
                                   mesh.get_coordinate())
        x = torch.from_numpy(inp["x"][xs]).to(dt)
        res[f"moe/{name}/rows"] = np.array([xs[0].start, xs[0].stop])
        with act.logical_axis_rules(mesh, rules):
            y, aux = moe.moe_ffn_sharded(params, x, cfg, capacity_factor=CF)
            res[f"moe/{name}/y"] = y.float().numpy()
            res[f"moe/{name}/aux"] = aux.numpy()
            if name in EP_CASES:
                with moe.ep_owner_shifted():
                    res[f"moe/{name}/y_shifted"] = moe.moe_ffn_sharded(
                        params, x, cfg, capacity_factor=CF)[0].float().numpy()
            if name in F32_CASES:
                with moe.combine_in(torch.float32):
                    res[f"moe/{name}/y_f32_combine"] = moe.moe_ffn_sharded(
                        params, x, cfg, capacity_factor=CF)[0].float().numpy()
            if case["mesh"][-1] > 2:
                # XLA's CPU psum of bf16: add in float32, round once
                dist.all_reduce = f32_wire
                try:
                    res[f"moe/{name}/y_f32_wire"] = moe.moe_ffn_sharded(
                        params, x, cfg, capacity_factor=CF)[0].float().numpy()
                finally:
                    dist.all_reduce = all_reduce

    mesh4 = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    part = torch.from_numpy(_ef_parts()[rank])
    mean, err = ef_compressed_mean(part, torch.zeros_like(part), mesh4, "pod")
    res["ef/mean"], res["ef/err"] = mean.numpy(), err.numpy()
    acc, acc_dropped = torch.zeros_like(part), torch.zeros_like(part)
    e = torch.zeros_like(part)
    for _ in range(20):
        m, e = ef_compressed_mean(part, e, mesh4, "pod")
        acc += m
        acc_dropped += ef_compressed_mean(part, torch.zeros_like(part), mesh4, "pod")[0]
    res["ef/avg20"], res["ef/avg20_dropped"] = (acc / 20).numpy(), (acc_dropped / 20).numpy()

    # a reduced olmoe forward of the rank's rows under a binding
    # (data-parallel over 4 ranks, weights whole: the serving layout, whose
    # MoE layers route the tokens of all four ranks together) against the
    # unbound forward of the whole batch
    # at olmoe's own capacity factor (reduced() raises it to 8): tokens drop,
    # so the capacity that routing counts from shows
    full = get_config("olmoe-1b-7b")
    cfg = dataclasses.replace(reduced(full), capacity_factor=full.capacity_factor)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(8, 16)).astype(np.int64))
    mesh41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    rules = act.default_rules(mesh41, cfg, batch=8, weight_fsdp=False)
    rows = sharding.local_slices(mesh41, P(rules["batch"], None), tokens.shape,
                                 mesh41.get_coordinate())[0]
    mine = tokens[rows]
    res["fwd/rows"] = np.array([rows.start, rows.stop])
    calls = []
    inner = transformer.moe_ffn_sharded

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    transformer.moe_ffn_sharded = counted
    with torch.no_grad():
        with act.logical_axis_rules(mesh41, rules):
            res["fwd/bound"] = model.logits(params, Batch(tokens=mine)).numpy()
        res["fwd/unbound"] = model.logits(params, Batch(tokens=tokens)).numpy()
    transformer.moe_ffn_sharded = inner
    res["fwd/sharded_calls"] = np.array(len(calls))
    res["fwd/moe_layers"] = np.array(sum(
        1 for k in model.plan.kinds if k.ffn == "moe") * model.plan.n_repeat)
    np.savez(out / f"rank{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


# ----------------------------------------------------------------- fixtures

def _spawn(args, env, log):
    return subprocess.Popen([sys.executable, str(HERE)] + args, env=env, cwd=str(ROOT),
                            stdout=log, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX process and four gloo ranks, started together."""
    d = tmp_path_factory.mktemp("distrib")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    logs = {n: open(d / f"{n}.log", "w") for n in ["jax"] + [f"rank{r}" for r in range(4)]}
    procs = {"jax": _spawn(["--jax", str(d)], env, logs["jax"])}
    for r in range(4):
        procs[f"rank{r}"] = _spawn(["--rank", str(r), "--world", "4", "--init",
                                    str(d / "rendezvous"), "--out", str(d)], env,
                                   logs[f"rank{r}"])
    failed = []
    for n, p in procs.items():
        try:
            rc = p.wait(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = "timeout"
        logs[n].close()
        if rc != 0:
            failed.append(f"{n}: {rc}\n" + (d / f"{n}.log").read_text()[-3000:])
    if failed:
        for p in procs.values():
            p.kill()
        pytest.fail("\n".join(failed))
    return {"jax": dict(np.load(d / "jax.npz")),
            "meta": json.loads((d / "jax.json").read_text()),
            "ranks": [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]}


# ---------------------------------------------------------------- spec trees

def _archs():
    from repro_torch.configs import ARCHS

    return [a.replace("_", "-") for a in ARCHS] + ["faas-bench"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tuple(tree) if isinstance(tree, tuple) else tree}


MESHES = {"data4_model2": ((4, 2), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", _archs())
def test_spec_trees_equal_jax(arch, mesh_name):
    import jax
    from repro.configs import get_config as jget
    from repro.distrib.act import default_rules as jdefault
    from repro.distrib.sharding import Rules as JRules
    from repro.models import build_model as jbuild
    from repro.optim import opt_state_specs as jopt

    from repro_torch.configs import get_config
    from repro_torch.distrib import AbstractMesh, Rules, default_rules
    from repro_torch.models import build_model
    from repro_torch.optim import opt_state_specs

    shape, names = MESHES[mesh_name]
    jmesh = jax.sharding.AbstractMesh(shape, names)
    mesh = AbstractMesh(names, shape)
    jcfg, cfg = jget(arch), get_config(arch)
    jshapes = jax.eval_shape(lambda: jbuild(jcfg).init(0))
    shapes = build_model(cfg).param_shapes()
    for wf in (True, False):
        jr, r = JRules(jmesh, weight_fsdp=wf), Rules(mesh, weight_fsdp=wf)
        ps, jps = r.param_specs(cfg), jr.param_specs(jcfg)
        assert _flat(ps) == _flat(jps), (arch, wf)
        for batch in (1, 8, 6):
            assert _flat(r.cache_specs(cfg, batch=batch)) == _flat(
                jr.cache_specs(jcfg, batch=batch)), (arch, wf, batch)
            for labels in (False, True):
                for prefix in (False, True):
                    kw = dict(batch=batch, with_labels=labels, prefix=prefix)
                    assert _flat(r.batch_specs(cfg, **kw)) == _flat(jr.batch_specs(jcfg, **kw))
            assert default_rules(mesh, cfg, batch=batch, weight_fsdp=wf) == jdefault(
                jmesh, jcfg, batch=batch, weight_fsdp=wf)
        for opt in ("adamw", "adafactor"):
            for zero2 in (None, (r.ax.batch, r.batch_size)):
                assert _flat(opt_state_specs(opt, ps, shapes, zero2=zero2)) == _flat(
                    jopt(opt, jps, jshapes, zero2=zero2)), (arch, wf, opt, zero2)


def test_mesh_helpers_match_jax():
    import jax
    from repro.distrib.sharding import fingerprint as jfp, mesh_axes as jaxes

    from repro_torch.distrib import AbstractMesh, fingerprint, mesh_axes

    for shape, names in MESHES.values():
        jm, m = jax.sharding.AbstractMesh(shape, names), AbstractMesh(names, shape)
        assert fingerprint(m) == jfp(jm)
        assert dataclasses.astuple(mesh_axes(m)) == dataclasses.astuple(jaxes(jm))


def test_partition_spec_normalises_one_name_tuples():
    from jax.sharding import PartitionSpec as JP

    from repro_torch.distrib import PartitionSpec as P

    for axes in [(("data",), "model", None), (("pod", "data"), None), (), (None,)]:
        assert tuple(P(*axes)) == tuple(JP(*axes))


# ---------------------------------------------------------------- placements

@pytest.mark.parametrize("i", range(len(PLACEMENT_CASES)))
def test_placements_match_devices_indices_map(runs, i):
    want = runs["meta"]["place"][i]
    for rank, res in enumerate(runs["ranks"]):
        assert res[f"place/{i}"].tolist() == want[str(rank)], (PLACEMENT_CASES[i], rank)
        assert res[f"place_local/{i}"].tolist() == want[str(rank)], (PLACEMENT_CASES[i], rank)


def test_placements_refuse_axes_out_of_mesh_order():
    from repro_torch.distrib import AbstractMesh, PartitionSpec as P, placements

    with pytest.raises(ValueError, match="mesh order"):
        placements(AbstractMesh(("data", "model"), (2, 2)), P(("model", "data")))


def test_shard_redistributes_a_dtensor(runs):
    for rank, res in enumerate(runs["ranks"]):
        assert bool(res["shard/is_dtensor"])
        assert res["shard/placements"].tolist() == ["S(0)", "S(1)"]
        d, m = divmod(rank, 2)
        want = np.arange(24.).reshape(4, 6)[2 * d:2 * d + 2, 3 * m:3 * m + 3]
        np.testing.assert_array_equal(res["shard/local"], want)
        assert res["shard/odd"].tolist() == ["R", "R"]  # 3 and 5 divide nothing
        assert bool(res["shard/plain_is_same"])


# ---------------------------------------------------------------- sharded MoE

def _bits_equal_fraction(a, b):
    return float(np.mean(a.view(np.uint32) == b.view(np.uint32)))


def _y_tolerance(name, want):
    """(rtol, atol, least bit-equal fraction) of a case's y against JAX's."""
    case = MOE_CASES[name]
    if name == "fallback":  # moe_ffn in float32: no bf16 combine
        return 1e-5, 1e-5, 0.0
    if case.get("dtype") == "bfloat16":  # bf16 expert products, as test_torch_moe
        return 0.0, 3e-2 * float(np.abs(want).max()), 0.0
    if case["mesh"][-1] > 2:  # bf16 sums of 4 partials, rounded at every hop
        return 2 ** -7, 2 ** -7 * float(np.abs(want).max()), 0.0
    return 2 ** -7, 1e-6, 0.95


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_sharded_matches_jax(runs, name):
    want_y = runs["jax"][f"moe/{name}/y"]
    want_aux = float(runs["jax"][f"moe/{name}/aux"])
    rtol, atol, bits = _y_tolerance(name, want_y)
    for rank, res in enumerate(runs["ranks"]):
        lo, hi = res[f"moe/{name}/rows"]
        got, want = res[f"moe/{name}/y"], want_y[lo:hi]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=f"{name} r{rank}")
        assert _bits_equal_fraction(got, want) >= bits, (name, rank)
        if MOE_CASES[name]["mesh"][-1] > 2:
            # XLA's CPU psum adds the bf16 partials in float32 and rounds
            # once; gloo rounds at every hop.  With the sum so, the bits
            # are JAX's.
            assert _bits_equal_fraction(res[f"moe/{name}/y_f32_wire"], want) >= 0.95, (
                name, rank)
        np.testing.assert_allclose(float(res[f"moe/{name}/aux"]), want_aux, rtol=1e-6)


@pytest.mark.parametrize("name", [n for n, c in MOE_CASES.items() if not c.get("int8")])
def test_moe_sharded_matches_moe_ffn(runs, name):
    """Each rank's y is its rows of ``moe_ffn`` over the rows of its FSDP
    shard with one routing group (in the training layout the rank's own
    rows; in the serving layout and the fallback the whole batch), up to
    the bf16 combine (the int8 gather's cases quantize the weights: they
    are held to JAX only)."""
    import torch

    from repro_torch.models.config import ModelConfig
    from repro_torch.models.moe import moe_ffn

    case = MOE_CASES[name]
    cfg = _moe_cfg(ModelConfig, case)
    dt = getattr(torch, cfg.dtype)
    inp = _moe_inputs(name)
    params = {k: torch.from_numpy(inp[k]).to(torch.float32 if k == "router" else dt)
              for k in ("router", "w_in", "w_gate", "w_out")}
    for rank, res in enumerate(runs["ranks"]):
        lo, hi = res[f"moe/{name}/rows"]
        if case.get("fsdp", True):
            x = torch.from_numpy(inp["x"][lo:hi]).to(dt)
            want = moe_ffn(params, x, cfg, capacity_factor=CF, groups=1)[0].float().numpy()
        else:
            x = torch.from_numpy(inp["x"]).to(dt)
            want = moe_ffn(params, x, cfg, capacity_factor=CF,
                           groups=1)[0].float().numpy()[lo:hi]
        got = res[f"moe/{name}/y"]
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2 ** -7 * float(np.abs(want).max()),
                                   err_msg=f"{name} r{rank}")


def test_moe_sharded_refuses_fsdp_axes_that_do_not_lead_the_batch():
    """JAX's tokens are the FSDP shard; the port reaches it from the rank's
    batch shard only where the FSDP axes lead the batch axes."""
    import torch

    from repro_torch.distrib import AbstractMesh, logical_axis_rules
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.moe import moe_ffn_sharded

    cfg = _moe_cfg(ModelConfig, MOE_CASES["ep"])
    rules = {"batch": ("pod", "data"), "moe_weight_fsdp": ("data",)}
    with logical_axis_rules(AbstractMesh(("pod", "data", "model"), (2, 2, 1)), rules):
        with pytest.raises(ValueError, match="leading part of the batch"):
            moe_ffn_sharded({}, torch.zeros(1, S, D), cfg)


@pytest.mark.parametrize("name", EP_CASES)
def test_control_ep_ownership_shifted_fails(runs, name):
    want_y = runs["jax"][f"moe/{name}/y"]
    worst = 0.0
    for res in runs["ranks"]:
        lo, hi = res[f"moe/{name}/rows"]
        want = want_y[lo:hi]
        err = np.abs(res[f"moe/{name}/y_shifted"] - want).max() / np.abs(want).max()
        worst = max(worst, float(err))
    assert worst > 0.1, worst


@pytest.mark.parametrize("name", F32_CASES)
def test_control_combine_in_float32_differs_from_jax_bits(runs, name):
    want_y = runs["jax"][f"moe/{name}/y"]
    for res in runs["ranks"]:
        lo, hi = res[f"moe/{name}/rows"]
        want = want_y[lo:hi]
        y, ctrl = res[f"moe/{name}/y"], res[f"moe/{name}/y_f32_combine"]
        # the bf16 combine leaves bf16 values, as JAX's does
        as_bf16 = (y.view(np.uint32) & 0xFFFF) == 0
        assert as_bf16.all()
        assert ((want.view(np.uint32) & 0xFFFF) == 0).all()
        assert _bits_equal_fraction(ctrl, want) < 0.5, _bits_equal_fraction(ctrl, want)


# -------------------------------------------------------- error-feedback mean

def test_ef_mean_matches_jax(runs):
    for rank, res in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(res["ef/err"], runs["jax"]["ef/err"][rank])
        np.testing.assert_array_max_ulp(res["ef/mean"], runs["jax"]["ef/mean"][rank], maxulp=2)


def test_ef_mean_one_shot_and_twenty_steps(runs):
    true_mean = _ef_parts().mean(0)
    for res in runs["ranks"]:
        assert np.abs(res["ef/mean"] - true_mean).max() < 0.05
        assert np.abs(res["ef/err"]).sum() > 0
        assert np.abs(res["ef/avg20"] - true_mean).max() < 0.01


def test_control_ef_residual_dropped_misses(runs):
    true_mean = _ef_parts().mean(0)
    for res in runs["ranks"]:
        assert np.abs(res["ef/avg20_dropped"] - true_mean).max() >= 0.01


def test_quantize_roundtrip_matches_jax():
    import jax.numpy as jnp
    import torch
    from repro.distrib.compress import dequantize_int8 as jdeq, quantize_int8 as jq

    from repro_torch.distrib.compress import dequantize_int8, quantize_int8

    x = np.random.default_rng(0).standard_normal(256).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    jqq, js = jq(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(), np.asarray(jdeq(jqq, js)))


# ------------------------------------------------------------ the model paths

def test_forward_under_a_binding_takes_moe_ffn_sharded(runs):
    """Each rank's bound forward takes ``moe_ffn_sharded`` in every MoE layer
    and gives its rows of the unbound forward of the whole batch: in the
    serving layout JAX routes the tokens of all batch shards together, with
    one capacity, as unbound ``moe_ffn`` does (up to the bf16 combine)."""
    for res in runs["ranks"]:
        assert int(res["fwd/sharded_calls"]) == int(res["fwd/moe_layers"]) > 0
        lo, hi = res["fwd/rows"]
        got, want = res["fwd/bound"], res["fwd/unbound"][lo:hi]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2 ** -7 * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ["faas-bench", "stablelm-3b", "mamba2-780m"])
def test_shard_unbound_leaves_forward_bit_equal(arch, monkeypatch):
    """Unbound, the forward with every ``shard`` call site live equals the
    forward with each replaced by a counting identity, bit for bit."""
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Batch, api, attention, build_model, layers, ssm, transformer

    cfg = get_config(arch)
    if arch != "faas-bench":
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, num_layers=min(cfg.num_layers, 2))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 32)).astype(np.int64))
    with torch.no_grad():
        want = model.logits(params, Batch(tokens=tokens))
        calls = []
        for mod in (api, attention, layers, ssm, transformer):
            monkeypatch.setattr(mod, "shard", lambda x, *names: calls.append(names) or x)
        got = model.logits(params, Batch(tokens=tokens))
    assert calls
    assert torch.equal(got, want)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax", default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--init", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if a.jax is not None:
        _jax_main(pathlib.Path(a.jax))
    else:
        _rank_main(a.rank, a.world, a.init, pathlib.Path(a.out))
