"""The port's training path against the JAX package's, on the CPU in
float32: ``Model.loss`` and every gradient leaf for faas-bench and the ten
reduced ``ARCHS`` (the grad-step half of ``tests/test_models.py``'s
``TestArchSmoke``), remat, the chunked cross-entropy, the optimizers, the
schedule and the clip, the train step with and without microbatches, the
trainer (the analogues of ``tests/test_runtime.py``'s ``TestTrainer``),
checkpoints across the two packages, and the host copy an async checkpoint
takes.  Inputs come from numpy seeds and reach both packages as the same
arrays."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.core.snapshot import SnapshotManifest as JManifest  # noqa: E402
from repro.core.snapshot import flatten_pytree  # noqa: E402
from repro.data.pipeline import ShardedLoader as JLoader  # noqa: E402
from repro.launch.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import Batch as JBatch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.transformer import chunked_cross_entropy as jax_cce  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.optim import clip_by_global_norm as jax_clip  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.optim import schedule as jax_schedule  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    flat_tensors,
    params_from_flat,
    params_to_flat,
    train_state_from_numpy,
    train_state_to_flat,
)
from repro_torch.core.snapshot import SnapshotManifest  # noqa: E402
from repro_torch.data.pipeline import ShardedLoader  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_train_state,
    make_train_step,
    train_state_shapes,
    value_and_grad,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import chunked_cross_entropy  # noqa: E402
from repro_torch.optim import OptimizerConfig, clip_by_global_norm, make_optimizer, schedule  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

# faas-bench whole and the ten ARCHS reduced, as tests/test_torch_decode.py
ARCHS = [
    ("stablelm-3b", True),
    ("mistral-nemo-12b", True),
    ("gemma-2b", True),
    ("gemma2-27b", True),
    ("faas-bench", False),
    ("mamba2-780m", True),
    ("olmoe-1b-7b", True),
    ("grok-1-314b", True),
    ("jamba-v0.1-52b", True),
    ("whisper-small", True),
    ("paligemma-3b", True),
]
N_FRAMES = 16


def _configs(name, reduce, **kw):
    jcfg, tcfg = jax_config(name), get_config(name)
    if reduce:
        jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
    return jcfg, tcfg


def _batch_np(cfg, b=2, s=32, seed=0):
    """tokens, labels (a few -1), and stub frame / patch embeddings."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    labels[:, :3] = -1
    out = {"tokens": tokens, "labels": labels}
    n = N_FRAMES if cfg.is_encoder_decoder else cfg.num_prefix_tokens
    if n:
        out["prefix_embeds"] = (rng.standard_normal((b, n, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _jb(d):
    return JBatch(tokens=jnp.asarray(d["tokens"]), labels=jnp.asarray(d["labels"]),
                  prefix_embeds=jnp.asarray(d["prefix_embeds"]) if "prefix_embeds" in d else None)


def _tb(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _flat_np(tree):
    return flatten_pytree(jax.tree.map(np.asarray, tree))


def _check_leaves(got: dict, want: dict, rel=1e-4, abs_=1e-7):
    assert sorted(got) == sorted(want)
    for path in want:
        w = np.asarray(want[path], np.float64)
        g = np.asarray(got[path], np.float64)
        assert g.shape == w.shape, path
        err = float(np.max(np.abs(g - w))) if w.size else 0.0
        assert err <= rel * float(np.max(np.abs(w), initial=0.0)) + abs_, (path, err)


def _jax_loss_and_grads(jm, jparams, d):
    loss, grads = jax.value_and_grad(lambda p: jm.loss(p, _jb(d)))(jparams)
    return float(loss), _flat_np(grads)


@pytest.mark.parametrize("name,reduce", ARCHS, ids=[a for a, _ in ARCHS])
def test_loss_and_every_gradient_leaf_match_jax(name, reduce):
    """Loss at 1e-5 relative; every gradient leaf within 1e-4 of its
    largest entry (+1e-7): float32 sums in another order."""
    jcfg, tcfg = _configs(name, reduce)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jm.init(0)
    params = params_from_flat(_flat_np(jparams), "cpu", template=tm.param_shapes())
    d = _batch_np(tcfg)
    jloss, jgrads = _jax_loss_and_grads(jm, jparams, d)
    loss, grads = value_and_grad(tm, params, _tb(d))
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss), (float(loss), jloss)
    _check_leaves({k: v for k, v in params_to_flat(grads).items()}, jgrads)


@pytest.mark.parametrize("name,reduce", ARCHS, ids=[a for a, _ in ARCHS])
def test_remat_gives_the_same_loss_and_gradients(name, reduce):
    """``remat=True`` with ``remat_group=2`` (checkpointed groups of
    checkpointed blocks) recomputes the same float32 arithmetic."""
    _, tcfg = _configs(name, reduce)
    plain, remat = build_model(tcfg), build_model(tcfg, remat=True, remat_group=2)
    params = plain.init(0, device="cpu")
    d = _tb(_batch_np(tcfg, seed=1))
    l0, g0 = value_and_grad(plain, params, d)
    l1, g1 = value_and_grad(remat, params, d)
    assert abs(float(l1) - float(l0)) <= 1e-6 * abs(float(l0))
    _check_leaves(params_to_flat(g1), params_to_flat(g0), rel=1e-5, abs_=1e-9)


# (b, s, D, V, chunk, final_softcap, tied, ignored labels)
CE_CASES = {
    "tied_divides": (2, 32, 16, 40, 8, 0.0, True, 0),
    "untied_gcd_chunk": (2, 24, 16, 40, 16, 0.0, False, 0),
    "softcap_ignored": (3, 20, 8, 33, 1024, 30.0, True, 5),
    "untied_softcap_gcd": (1, 18, 8, 50, 12, 5.0, False, 4),
}


@pytest.mark.parametrize("name", sorted(CE_CASES))
def test_chunked_cross_entropy_matches_jax(name):
    """Value and gradients (h and the table) against JAX's: a chunk that
    does not divide s (gcd), ``final_softcap``, labels -1, tied (V, D) and
    untied (D, V) heads."""
    b, s, D, V, chunk, cap, tied, ignored = CE_CASES[name]
    rng = np.random.default_rng(7)
    h = rng.standard_normal((b, s, D)).astype(np.float32)
    table = (rng.standard_normal((V, D) if tied else (D, V)) * 0.5).astype(np.float32)
    labels = rng.integers(0, V, (b, s), dtype=np.int32)
    labels.reshape(-1)[rng.choice(b * s, ignored, replace=False)] = -1
    kw = dict(final_softcap=cap, chunk=chunk, transpose_head=not tied)
    jl, (jgh, jgt) = jax.value_and_grad(
        lambda hh, tt: jax_cce(hh, tt, jnp.asarray(labels), **kw), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(table))
    th, tt = torch.from_numpy(h).requires_grad_(True), torch.from_numpy(table).requires_grad_(True)
    tl = chunked_cross_entropy(th, tt, torch.from_numpy(labels), **kw)
    gh, gt = torch.autograd.grad(tl, (th, tt))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------ optimizers

def _opt_tree(seed):
    """A stacked 3-D leaf (its f32 bytes over the small update_chunk_bytes
    below), a matrix, a vector and a bf16 matrix."""
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": rng.standard_normal((3, 6, 8)).astype(np.float32),
                       "b": rng.standard_normal((10,)).astype(np.float32)},
            "head": {"m": rng.standard_normal((5, 7)).astype(np.float32),
                     "bf": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16)}}


def _to_t(tree):
    return params_from_flat(flatten_pytree(tree), "cpu")


def _to_j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("n_updates", [1, 3])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_jax(name, n_updates):
    """Identical gradients, 1 and 3 updates: parameters (a bf16 leaf
    among them) and every state leaf at 1e-6.  ``update_chunk_bytes`` is
    small, so the stacked leaf is updated slice by slice."""
    kw = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=10, update_chunk_bytes=256)
    cfg, jcfg = OptimizerConfig(**kw), JOptimizerConfig(**kw)
    params_np = _opt_tree(0)
    jinit, jupd = jax_make_optimizer(jcfg)
    tinit, tupd = make_optimizer(cfg)
    jp = _to_j(params_np)
    jst = jinit(jp)
    tp = _to_t(params_np)
    tst = tinit(tp)
    for i in range(n_updates):
        g = _opt_tree(100 + i)
        g["head"]["bf"] = g["head"]["bf"].astype(np.float32).astype(ml_dtypes.bfloat16)
        jp, jst = jupd(_to_j(g), jst, jp)
        tp, tst = tupd(_to_t(g), tst, tp)
    got, want = params_to_flat({"p": tp, "s": tst}), _flat_np({"p": jp, "s": jst})
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if w.dtype.name == "bfloat16":
            g = g.view(ml_dtypes.bfloat16)
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=1e-6,
                                   atol=1e-7, err_msg=path)


def test_adafactor_chunking_changes_the_update():
    """Slice-by-slice update clipping (one RMS per slice of axis 0) is not
    the whole-leaf clipping: the port keeps JAX's ``_chunked`` behaviour."""
    params_np, g = _opt_tree(0), _opt_tree(100)
    out = []
    for chunk_bytes in (256, 1 << 30):
        cfg = OptimizerConfig(name="adafactor", lr=1e-2, warmup_steps=0,
                              update_chunk_bytes=chunk_bytes)
        init, upd = make_optimizer(cfg)
        p = _to_t(params_np)
        p, _ = upd(_to_t(g), init(p), p)
        out.append(p["blocks"]["w"].clone())
    assert not torch.allclose(out[0], out[1], rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
def test_adafactor_one_layer_leaf_matches_jax(dtype):
    """A leaf of one stacked layer, (1, experts, rows, cols), over
    ``update_chunk_bytes``: JAX's ``lax.map`` leaves it whole; the port
    walks its matrices in two passes with the whole leaf's RMS.  Three
    updates, parameters and factored statistics at 1e-6."""
    kw = dict(name="adafactor", lr=1e-2, warmup_steps=2, total_steps=10, update_chunk_bytes=256)
    cfg, jcfg = OptimizerConfig(**kw), JOptimizerConfig(**kw)
    rng = np.random.default_rng(7)
    params_np = {"moe": {"w": rng.standard_normal((1, 3, 6, 8)).astype(dtype)}}
    jinit, jupd = jax_make_optimizer(jcfg)
    tinit, tupd = make_optimizer(cfg)
    jp = _to_j(params_np)
    jst = jinit(jp)
    tp = _to_t(params_np)
    tst = tinit(tp)
    for i in range(3):
        g = {"moe": {"w": (rng.standard_normal((1, 3, 6, 8)) * 10 ** i).astype(dtype)}}
        jp, jst = jupd(_to_j(g), jst, jp)
        tp, tst = tupd(_to_t(g), tst, tp)
    got, want = params_to_flat({"p": tp, "s": tst}), _flat_np({"p": jp, "s": jst})
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if w.dtype.name == "bfloat16":
            g = g.view(ml_dtypes.bfloat16)
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=1e-6,
                                   atol=1e-7, err_msg=path)


def test_schedule_and_clip_match_jax():
    """The schedule at step 0, inside the warmup, at its end, mid-decay
    and past the end; the clip with ``prescale`` and the norm it returns."""
    cfg = OptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=110)
    jcfg = JOptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=110)
    for step in (0, 3, 10, 60, 110, 500):
        got = float(schedule(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(jax_schedule(jcfg, jnp.asarray(step, jnp.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step
    g = _opt_tree(3)
    for max_norm, prescale in ((1.0, 0.5), (100.0, 1.0), (0.1, 0.25)):
        tg, tn = clip_by_global_norm(_to_t(g), max_norm, prescale=prescale)
        jg, jn = jax_clip(_to_j(g), max_norm, prescale=prescale)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        got, want = params_to_flat(tg), _flat_np(jg)
        for path, w in want.items():
            gg = got[path].view(ml_dtypes.bfloat16) if w.dtype.name == "bfloat16" else got[path]
            np.testing.assert_allclose(gg.astype(np.float64), w.astype(np.float64),
                                       rtol=1e-6, err_msg=path)


def test_clip_scales_the_given_tensors_in_place():
    """The train step's gradients are scaled where they lie (a copy of a
    model's gradients would double their memory): the same tensors come
    back, each scaled."""
    given = _to_t(_opt_tree(4))
    before = {path: t.clone() for path, t in flat_tensors(given)}
    got, _ = clip_by_global_norm(given, 0.1, prescale=0.5)
    assert got is given
    for path, t in flat_tensors(got):
        assert not torch.equal(t, before[path]), path


# ------------------------------------------------------------------ train step

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax_over_three_steps(microbatches):
    """stablelm-3b reduced: three steps of the port's train step and JAX's
    jitted one from the same state and batches; losses at 1e-5, grad norms
    at 1e-4, and every parameter and moment within 1e-5 of its scale plus
    steps x lr x 5e-3: AdamW's update lr m / sqrt(v) is O(lr) per entry and
    normalises each entry's gradient, so the float32 sum-order error of a
    small gradient entry (1e-4 of the leaf's largest) moves its update by up
    to a few parts in 1e3."""
    jcfg, tcfg = _configs("stablelm-3b", True)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jstep = jax.jit(jax_make_train_step(jm, JOptimizerConfig(**kw), microbatches=microbatches))
    tstep = make_train_step(tm, OptimizerConfig(**kw), microbatches=microbatches)
    jparams = jm.init(0)
    jinit, _ = jax_make_optimizer(JOptimizerConfig(**kw))
    jstate = {"params": jparams, "opt": jinit(jparams)}
    tstate = train_state_from_numpy(_flat_np(jstate), "cpu",
                                    template=train_state_shapes(tm, OptimizerConfig(**kw)))
    for i in range(3):
        d = _batch_np(tcfg, b=4, s=16, seed=20 + i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in d.items()})
        tstate, tmet = tstep(tstate, _tb(d))
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
        assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-4)
    _check_leaves(train_state_to_flat(tstate), _flat_np(jstate), rel=1e-5,
                  abs_=3 * kw["lr"] * 5e-3)


def test_train_state_template_matches_the_state():
    """``train_state_shapes`` (meta tensors) has the state's paths, shapes
    and dtypes, and the step counter is an int32 0-d tensor."""
    tm = build_model(reduced(get_config("olmoe-1b-7b")))
    for name in ("adamw", "adafactor"):
        opt = OptimizerConfig(name=name)
        st = make_train_state(tm, opt, 0, device="cpu")
        tpl = train_state_shapes(tm, opt)
        assert st["opt"]["step"].dtype == torch.int32 and st["opt"]["step"].dim() == 0
        a, b = flat_tensors(st), flat_tensors(tpl)
        assert [(p, tuple(t.shape), t.dtype) for p, t in a] == \
               [(p, tuple(t.shape), t.dtype) for p, t in b]
        assert all(t.device.type == "meta" for _, t in b)


# ------------------------------------------------------------------ trainer

def _tiny_trainer(tmp_path, **kw):
    cfg = reduced(get_config("stablelm-3b"))
    model = build_model(cfg)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    loader = ShardedLoader(seed=0, vocab=cfg.vocab_size, seq_len=32,
                           batch_per_shard=2, num_shards=1, owned=[0])
    tcfg = TrainerConfig(workdir=str(tmp_path / "run"), checkpoint_every=3,
                         async_checkpoint=kw.pop("async_checkpoint", False), **kw)
    return Trainer(model, opt, loader, tcfg, device="cpu"), loader


def test_trainer_loss_decreases(tmp_path):
    tr, _ = _tiny_trainer(tmp_path)
    tr.init_state()
    tr.train(8)
    losses = [m["loss"] for m in tr.metrics_log]
    assert losses[-1] < losses[0]
    assert all(np.isfinite(l) for l in losses)


def test_trainer_crash_resume_continues_stream(tmp_path):
    """Crash at step 6, resume: the train state and the data cursor come
    back, and the losses are an uninterrupted run's."""
    tr1, _ = _tiny_trainer(tmp_path)
    tr1.init_state()
    with pytest.raises(RuntimeError):
        tr1.train(10, fail_at=6)
    tr2, _ = _tiny_trainer(tmp_path)
    assert tr2.resume()
    assert tr2.step == 6
    tr2.train(4)
    ref, _ = _tiny_trainer(tmp_path / "ref")
    ref.init_state()
    ref.train(10)
    got = [m["loss"] for m in tr1.metrics_log] + [m["loss"] for m in tr2.metrics_log]
    np.testing.assert_allclose(got, [m["loss"] for m in ref.metrics_log], rtol=1e-4)


def test_trainer_checkpoint_dedup(tmp_path):
    tr, _ = _tiny_trainer(tmp_path)
    tr.init_state()
    tr.train(3)
    b1 = tr.store.stored_bytes()
    tr.train(3)
    assert tr.store.stored_bytes() < 2.2 * b1


def test_async_checkpoint_holds_the_state_of_its_step(tmp_path, monkeypatch):
    """The async writer hashes the host copy after the next step has
    updated the tensors in place: the restored state is the one of the
    checkpoint's step, not of the step after (a host "copy" that shares a
    CPU tensor's storage fails this)."""
    gate = threading.Event()
    write = ttrainer._write

    def held_write(*args):
        assert gate.wait(60)
        return write(*args)

    monkeypatch.setattr(ttrainer, "_write", held_write)
    tr, _ = _tiny_trainer(tmp_path, async_checkpoint=True)
    tr.init_state()
    tr.train(2)
    at_ckpt = {k: v.copy() for k, v in train_state_to_flat(tr.state).items()}
    tr.train(1)  # checkpoint at step 3 submitted, its write held
    snap3 = {k: v.copy() for k, v in train_state_to_flat(tr.state).items()}
    tr.train(1)  # step 4 updates the tensors in place
    gate.set()
    tr.writer.drain()
    tr.close()
    back, _ = _tiny_trainer(tmp_path)
    assert back.resume() and back.step == 3
    restored = train_state_to_flat(back.state)
    assert sorted(restored) == sorted(snap3)
    for k in snap3:
        np.testing.assert_array_equal(restored[k], snap3[k], err_msg=k)
    assert any(not np.array_equal(at_ckpt[k], snap3[k]) for k in snap3)


def _jax_trainer(tmp_path, cfg):
    jm = jax_build(cfg)
    opt = JOptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    loader = JLoader(seed=0, vocab=cfg.vocab_size, seq_len=32, batch_per_shard=2,
                     num_shards=1, owned=[0])
    tcfg = JTrainerConfig(workdir=str(tmp_path), checkpoint_every=3, async_checkpoint=False)
    return JTrainer(jm, opt, loader, tcfg)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A checkpoint written by the JAX trainer (step 3) resumes in the
    port's trainer, with its data cursor; the next losses are JAX's
    continued run's at rtol 1e-4."""
    jcfg = jax_reduced(jax_config("stablelm-3b"))
    jtr = _jax_trainer(tmp_path / "run", jcfg)
    jtr.init_state(0)
    jtr.train(6)
    want = [m["loss"] for m in jtr.metrics_log[3:]]
    jtr.close()
    (tmp_path / "run" / "LATEST").write_text("ckpt-00000003")
    tr, _ = _tiny_trainer(tmp_path)
    assert tr.resume() and tr.step == 3
    tr.train(3)
    np.testing.assert_allclose([m["loss"] for m in tr.metrics_log], want, rtol=1e-4)


def test_train_state_has_the_same_chunk_digests_in_both_packages(tmp_path):
    """The JAX trainer's train state and the port's copy of it, each
    checkpointed by its own package, give equal chunk digests leaf by
    leaf."""
    jcfg = jax_reduced(jax_config("stablelm-3b"))
    jtr = _jax_trainer(tmp_path / "jax", jcfg)
    jtr.init_state(0)
    jtr.train(1)
    jtr.checkpoint()
    jtr.close()
    tr, _ = _tiny_trainer(tmp_path / "port")
    tr.state = train_state_from_numpy(
        _flat_np(jtr.state), "cpu", template=train_state_shapes(tr.model, tr.opt_cfg))
    tr.step = 1
    tr.checkpoint()
    tr.close()
    jm = JManifest.load(str(tmp_path / "jax"), "ckpt-00000001")
    tm = SnapshotManifest.load(str(tmp_path / "port" / "run"), "ckpt-00000001")
    assert sorted(jm.arrays) == sorted(tm.arrays)
    for path in jm.arrays:
        assert [c.digest for c in jm.arrays[path].chunks] == \
               [c.digest for c in tm.arrays[path].chunks], path


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_jax_train_state_crosses_into_the_port_and_back(name):
    """A JAX train state (AdamW's ``m`` / ``v`` / ``step``, or Adafactor's
    ``v`` tree of ``{"vr", "vc"}`` and ``{"v"}`` leaves with bf16 params)
    crosses into the port's tensors and back to the same flat arrays."""
    jcfg = dataclasses.replace(jax_reduced(jax_config("olmoe-1b-7b")), dtype="bfloat16")
    tcfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")), dtype="bfloat16")
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jinit, _ = jax_make_optimizer(JOptimizerConfig(name=name))
    jparams = jm.init(0)
    flat = _flat_np({"params": jparams, "opt": jinit(jparams)})
    state = train_state_from_numpy(flat, "cpu",
                                   template=train_state_shapes(tm, OptimizerConfig(name=name)))
    assert state["params"]["embed"]["table"].dtype == torch.bfloat16
    back = train_state_to_flat(state)
    assert sorted(back) == sorted(flat)
    for path, want in flat.items():
        got = back[path]
        if want.dtype.name == "bfloat16":
            got = got.view(ml_dtypes.bfloat16)
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
