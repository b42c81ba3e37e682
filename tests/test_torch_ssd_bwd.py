"""The SSD scan's backward, on the CPU.

The CUDA backward (``src/repro_torch/csrc/ssd_scan_bwd.cu``) runs only on
the card.  What is checked here:

- its plain version ``ssd_bwd_ref``, written in the kernel's decomposition
  (the reverse state pass, the intra-chunk products, dt through the
  straddling sums), against ``jax.vjp`` of ``repro.models.ssm.ssd_chunked``
  and against float64 autograd through ``ssd_ref``, with and without a
  gradient of the final state; controls that must miss the tolerance: the
  inter-chunk state gradient dropped, dt's path through the decays
  dropped, and, at mamba2-780m's own decays, dL/da summed per row and in
  reverse (the form autodiff takes) instead of the straddling form;
- the backward's launch plan (``bwd_launch_plan``): every SSM configuration
  and every CUDA-test shape fits two chunk CTAs an SM, the grid fills the
  card at the train shapes, the scratch falls below what per-head
  partials of dB and dC would take, every plan is an instantiation of the
  source;
- ``_SsdScan``'s plumbing, with the CUDA route forced on CPU tensors and the
  kernel entry points replaced by the plain versions: gradients through the
  mixer's xBC views, the final state's gradient, and a mamba2 train step
  equal to the CPU's.

Tolerances, each against the largest entry of the gradient it checks:
float32 2e-5 (the forward kernel's y tolerance), dA 1e-4: dA is one signed
sum per head over every row of the batch, whose terms sum in absolute value
to several times the result, and JAX's own float32 dA lies 3.8e-5 from
float64 at mamba2's width.  Per-row dcs summed in a float32 suffix sum
stays inside that tolerance at the mild decays of ``CASES`` (dA 4.7e-6
against the straddling form's 1.2e-6 at 16 heads).  At mamba2-780m's
heads 8-15 (A = -8..-15, dt = softplus at init: cs falls by about 5 to 10
a row) dA's terms cancel to 1/15-1/45 of their absolute sum, and dA is
held per head to 1e-5 of that absolute sum: the straddling form meets it
(at most 3.5e-6 over six seeds), per-row dcs misses it (at least 9.6e-5)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduced  # noqa: E402
from repro_torch.convert import flat_tensors  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref_module  # noqa: E402
from repro_torch.kernels.ssd import ssd_bwd_ref, ssd_op, ssd_ref  # noqa: E402
from repro_torch.kernels.ssd.kernel import (  # noqa: E402
    BWD_KERNELS_PER_CALL,
    BWD_MAX_CHUNK,
    SMEM_PER_BLOCK,
    bwd_launch_plan,
    bwd_smem,
)
from repro_torch.launch.steps import make_train_state, make_train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402

F32_REL = 2e-5
DA_REL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")

# (b, l, nh, hd, ds, chunk)
CASES = {
    "one_chunk": (2, 64, 4, 16, 16, 64),
    "four_chunks": (1, 128, 4, 16, 32, 32),
    "reduced_mamba2": (2, 64, 8, 32, 16, 32),     # reduced(mamba2-780m)'s mixer
    "jamba_like": (1, 128, 8, 64, 16, 64),        # jamba's ds 16, 8 heads
    "mamba2_width": (1, 512, 4, 64, 128, 256),    # mamba2-780m's hd, ds, chunk: two chunks
}


# mamba2-780m's width at its heads 8-15: A = -exp(A_log) with A_log = log(1..48)
MAMBA2_DECAYS = (2, 512, 8, 64, 128, 256)
MAMBA2_HEADS = range(8, 16)


def _inputs(case, seed=0, dstate=True, mamba2_decays=False):
    """x, dt, A, B, C, D, dy and dstate (or None) as float32 numpy arrays;
    ``mamba2_decays``: A of mamba2-780m's heads 8-15 and dt = softplus(0.1
    N(0, 1)), as at init (dt_bias 0)."""
    b, l, nh, hd, ds = case[:5]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, l, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (nh,)).astype(np.float32)
    if mamba2_decays:
        A = -np.asarray(MAMBA2_HEADS, np.float32)[:nh]
        dt = np.log1p(np.exp(0.1 * rng.standard_normal((b, l, nh)))).astype(np.float32)
    B = rng.standard_normal((b, l, ds)).astype(np.float32)
    C = rng.standard_normal((b, l, ds)).astype(np.float32)
    D = rng.standard_normal((nh,)).astype(np.float32)
    dy = rng.standard_normal((b, l, nh, hd)).astype(np.float32)
    dS = rng.standard_normal((b, nh, hd, ds)).astype(np.float32) if dstate else None
    return x, dt, A, B, C, D, dy, dS


def _ref_grads(arrs, chunk):
    x, dt, A, B, C, D, dy, dS = arrs
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C, D, dy)]
    return ssd_bwd_ref(*t, None if dS is None else torch.from_numpy(dS), chunk=chunk)


def _float64_grads(arrs, chunk):
    """Autograd through the plain forward in float64."""
    x, dt, A, B, C, D, dy, dS = arrs
    leaves = [torch.from_numpy(a).double().requires_grad_(True) for a in (x, dt, A, B, C, D)]
    y, st = ssd_ref(*leaves, chunk=chunk)
    loss = (y * torch.from_numpy(dy).double()).sum()
    if dS is not None:
        loss = loss + (st * torch.from_numpy(dS).double()).sum()
    return torch.autograd.grad(loss, leaves)


def _rel(got, want) -> float:
    """max |got - want| / max |want|"""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want.detach() if isinstance(want, torch.Tensor) else want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _assert_close(got, want):
    for name, g, w in zip(NAMES, got, want):
        tol = DA_REL if name == "dA" else F32_REL
        assert _rel(g, w) <= tol, (name, _rel(g, w))


# ------------------------------------------------------------ the plain backward

@pytest.mark.parametrize("dstate", [True, False], ids=["dstate", "no_dstate"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_ref_matches_jax_vjp(name, dstate):
    case = CASES[name]
    arrs = _inputs(case, dstate=dstate)
    x, dt, A, B, C, D, dy, dS = arrs
    (_, st), vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk=case[5]),
                           *map(jnp.asarray, (x, dt, A, B, C, D)))
    want = vjp((jnp.asarray(dy), jnp.zeros_like(st) if dS is None else jnp.asarray(dS)))
    _assert_close(_ref_grads(arrs, case[5]), want)


@pytest.mark.parametrize("dstate", [True, False], ids=["dstate", "no_dstate"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_ref_matches_float64_autograd(name, dstate):
    case = CASES[name]
    arrs = _inputs(case, seed=1, dstate=dstate)
    _assert_close(_ref_grads(arrs, case[5]), _float64_grads(arrs, case[5]))


def test_bwd_ref_returns_each_gradient_in_its_inputs_dtype():
    """bf16 x, B, C (dy in y's dtype): dx, dB, dC come back in bf16, the
    rest in float32, within bf16's 2e-2 of float64 autograd."""
    case = CASES["reduced_mamba2"]
    x, dt, A, B, C, D, dy, dS = _inputs(case, seed=2)
    bf = [torch.from_numpy(a).bfloat16() for a in (x, B, C, dy)]
    got = ssd_bwd_ref(bf[0], torch.from_numpy(dt), torch.from_numpy(A), bf[1], bf[2],
                      torch.from_numpy(D), bf[3], torch.from_numpy(dS), chunk=case[5])
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16, torch.float32]
    exact = [t.float().numpy() for t in bf]
    want = _float64_grads((exact[0], dt, A, exact[1], exact[2], D, exact[3], dS), case[5])
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.float(), w) <= 2e-2, name


def _without_carry(local, last, dstate):
    """The reverse pass with the inter-chunk term dropped: only the last
    chunk sees the final state's gradient."""
    out = torch.zeros_like(local)
    if dstate is not None:
        out[:, -1] = dstate
    return out


@pytest.mark.parametrize("control,grads", [
    ("inter-chunk dS dropped", ("dx", "dB", "ddt")),
    ("dt through the decays dropped", ("ddt", "dA")),
])
def test_controls_miss_the_tolerance(monkeypatch, control, grads):
    """Each fault in the decomposition misses a tolerance that the plain
    backward meets, at mamba2's width (two chunks) and at reduced mamba2
    (two chunks of 32)."""
    for name in ("mamba2_width", "reduced_mamba2"):
        case = CASES[name]
        arrs = _inputs(case, seed=3)
        want = _float64_grads(arrs, case[5])
        with monkeypatch.context() as m:
            if control == "inter-chunk dS dropped":
                m.setattr(ssd_ref_module, "reverse_state_pass", _without_carry)
            else:
                m.setattr(ssd_ref_module, "decay_grad", lambda W, V, E, U: torch.zeros_like(V))
            bad = dict(zip(NAMES, _ref_grads(arrs, case[5])))
        for g in grads:
            assert _rel(bad[g], want[NAMES.index(g)]) > 100 * DA_REL, (name, g)


def _per_row_dcs(W, V, E, U):
    """dL/da as autodiff forms it: per row dcs_i (the row's and column's
    sums of W, V_i, -U_i, and at the last row E and every U), summed in
    reverse in float32 (``prefix_sum``'s order)."""
    c = W.shape[2]
    i = torch.arange(c)
    tri = (i[:, None] >= i[None, :])[:, :, None]
    dcs = (W * tri).sum(3) - (W * tri).sum(2) + V - U
    dcs[:, :, -1] += E + U.sum(2)
    return torch.flip(ssd_ref_module.prefix_sum(torch.flip(dcs, [2]), 2), [2])


DA_TERMS_REL = 1e-5


def _da_term_scale(arrs, chunk, monkeypatch):
    """Per head, the absolute sum over the rows of dA's terms dt_k dL/da_k,
    in float64 (the plain backward computed in float64)."""
    seen = {}
    decay_grad = ssd_ref_module.decay_grad

    def keep(W, V, E, U):
        seen["da"] = decay_grad(W, V, E, U)
        return seen["da"]

    x, dt, A, B, C, D, dy, dS = (None if a is None else torch.from_numpy(a).double()
                                 for a in arrs)
    with monkeypatch.context() as m:
        m.setattr(ssd_ref_module, "decay_grad", keep)
        ssd_bwd_ref(x, dt, A, B, C, D, dy, dS, chunk=chunk)
    b, l, nh = dt.shape
    return (dt.reshape(b, l // chunk, chunk, nh) * seen["da"]).abs().sum((0, 1, 2))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straddling_form_holds_da_at_mamba2_decays(monkeypatch, seed):
    """At mamba2-780m's heads 8-15 dA is a signed sum per head whose terms'
    absolute sum is 15-45x |dA|: its error is held per head to 1e-5 of that
    absolute sum (about 80 float32 ulps of it), the other gradients to
    F32_REL.  The straddling form meets it; per-row dcs summed in reverse
    (what autodiff forms) misses it by about 10x or more."""
    chunk = MAMBA2_DECAYS[5]
    arrs = _inputs(MAMBA2_DECAYS, seed=seed, dstate=False, mamba2_decays=True)
    want = _float64_grads(arrs, chunk)
    scale = _da_term_scale(arrs, chunk, monkeypatch)
    good = _ref_grads(arrs, chunk)
    for name, g, w in zip(NAMES, good, want):
        if name != "dA":
            assert _rel(g, w) <= F32_REL, name
    with monkeypatch.context() as m:
        m.setattr(ssd_ref_module, "decay_grad", _per_row_dcs)
        bad = _ref_grads(arrs, chunk)

    def err(g):
        return float(((g.double() - want[2]).abs() / scale).max())

    assert err(good[2]) <= DA_TERMS_REL
    assert err(bad[2]) > DA_TERMS_REL


# ------------------------------------------------------------ the launch plan

def _ssm_configs():
    out = []
    for name in list_archs():
        cfg = get_config(name)
        if cfg.ssm_state:
            out += [(name, cfg), (name + "-reduced", reduced(cfg))]
    return out


# tests/test_torch_cuda.py's backward shapes and chip_smoke.py's
CUDA_SHAPES = {
    "reduced_mamba2": (2, 96, 8, 32, 16, 32),
    "mamba2_two_chunks": (1, 512, 8, 64, 128, 256),
    "jamba_ds16": (1, 512, 16, 64, 16, 256),
    "ragged_tiles": (1, 192, 3, 32, 16, 96),
    "odd_dims": (1, 80, 3, 24, 40, 40),
    "mamba2_train": (4, 1024, 48, 64, 128, 256),
    "mamba2_train_step_f32": (2, 512, 48, 64, 128, 256),
    "jamba_train": (1, 1024, 128, 64, 16, 256),
    "mamba2_l8192": (1, 8192, 48, 64, 128, 256),
    "chunk_1024": (1, 2048, 3, 64, 128, 1024),
}


def _check_bwd_plan(plan, b, l, nh, hd, ds, chunk, dtype):
    assert plan.state_pad >= ds and (plan.state_pad == 64 or plan.state_pad // 2 < ds)
    assert plan.chunks == l // chunk and plan.row_tiles == -(-chunk // 64)
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert (plan.smem_chunk, plan.smem_local) == bwd_smem(itemsize, plan.state_pad)
    # two chunk CTAs an SM: each CTA's shared memory plus its 1 KiB reserve
    assert plan.ctas_per_sm == 2 and 2 * (plan.smem_chunk + 1024) <= 233_472
    assert plan.smem_local <= SMEM_PER_BLOCK
    assert plan.head_group in (1, 2, 4) and plan.groups == -(-nh // plan.head_group)
    assert plan.grid_chunk == (b * l // chunk, plan.groups, plan.row_tiles)
    assert plan.grid_local == plan.grid_finish == (b * l // chunk, nh)
    assert plan.grid_pass[0] * 1024 >= hd * ds and plan.grid_pass[1:] == (nh, b)
    assert plan.grid_reduce[0] * 256 >= b * l * ds
    nc, nt = l // chunk, plan.row_tiles
    pairs = nt * (nt + 1) // 2
    # float32 forms C.B^T and its transpose once per (batch x chunk, tile pair)
    assert plan.grid_cb == (b * nc, pairs if itemsize == 4 else 0, 2)
    assert plan.kernels == BWD_KERNELS_PER_CALL[dtype] == (6 if itemsize == 4 else 5)
    n = b * nc * nh
    r4 = lambda v: -(-v // 4) * 4  # noqa: E731
    want = (2 * r4(n * hd * ds) + r4(n * -(-hd * ds // 1024)) + r4(n * (2 + nt) * chunk)
            + r4(n * nt) + 2 * r4(b * nc * plan.groups * chunk * ds) + 2 * r4(n)
            + (b * nc * pairs * 2 * 64 * 64 if itemsize == 4 else 0))
    assert plan.scratch_bytes == 4 * want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name,cfg", _ssm_configs(), ids=lambda x: x
                         if isinstance(x, str) else "")
def test_bwd_plan_takes_every_ssm_config(name, cfg, dtype):
    chunk = cfg.ssm_chunk
    for l in (chunk, 4 * chunk):
        plan = bwd_launch_plan(dtype, cfg.ssm_head_dim, cfg.ssm_state, chunk, batch=2,
                               heads=cfg.ssm_heads, seq=l)
        _check_bwd_plan(plan, 2, l, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, chunk,
                        dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CUDA_SHAPES))
def test_bwd_plan_takes_every_cuda_shape(name, dtype):
    b, l, nh, hd, ds, chunk = CUDA_SHAPES[name]
    plan = bwd_launch_plan(dtype, hd, ds, chunk, batch=b, heads=nh, seq=l)
    _check_bwd_plan(plan, b, l, nh, hd, ds, chunk, dtype)


def test_bwd_grid_is_chunk_parallel_at_the_train_shapes():
    """The grid fills the card at the train shapes: two chunk CTAs an SM on
    132 SMs and at least two waves of them.  mamba2-780m at b 4 x l 1024: a
    CTA per (batch x chunk, 4 heads, 64-row tile), 768 CTAs, 2.9 waves, 12
    dB / dC partials (one a head: 48); its float32 step (b 2 x l 512) one
    head a CTA, 768; jamba's period at b 1: 2 heads a CTA, 1024."""
    for dtype in (torch.bfloat16, torch.float32):
        plan = bwd_launch_plan(dtype, 64, 128, 256, batch=4, heads=48, seq=1024)
        assert plan.grid_chunk == (16, 12, 4) and plan.ctas == 768
        assert (plan.head_group, plan.groups) == (4, 12)
        assert plan.ctas_per_sm == 2 and 2 < plan.waves < 3
    step = bwd_launch_plan(torch.float32, 64, 128, 256, batch=2, heads=48, seq=512)
    assert step.head_group == 1 and step.ctas == 768
    jamba = bwd_launch_plan(torch.bfloat16, 64, 16, 256, batch=1, heads=128, seq=1024)
    assert jamba.head_group == 2 and jamba.ctas == 1024 and jamba.state_pad == 64
    for plan in (step, jamba):
        assert plan.waves >= 2


def test_bwd_scratch_falls_below_the_per_head_partials():
    """At mamba2-780m's train shape the bf16 scratch is 105.4 MB: the 12 head
    groups' dB and dC partials (50.3 MB), the local and outgoing states
    (50.3 MB), the per-row sums (4.8 MB); float32 adds C.B^T both ways per
    tile pair (5.2 MB).  A design with per-head partials of dB and dC (and
    float32 local and outgoing states, per-chunk dA / dD terms) takes 251.7
    MB, 201 MB of it those partials."""
    per_head = 4 * (2 * 16 * 48 * 64 * 128 + 2 * 4 * 1024 * 48 * 128 + 2 * 16 * 48)
    assert per_head == 251_664_384
    bf16 = bwd_launch_plan(torch.bfloat16, 64, 128, 256, batch=4, heads=48, seq=1024)
    f32 = bwd_launch_plan(torch.float32, 64, 128, 256, batch=4, heads=48, seq=1024)
    assert bf16.scratch_bytes == 105_424_896 < per_head
    assert f32.scratch_bytes == 105_424_896 + 4 * 16 * 20 * 4096 < per_head


def test_every_bwd_plan_is_an_instantiation():
    """The launcher refuses a plan it has no instantiation for: every
    (dtype, ds) the plan takes maps to one (dtype, padded ds) the source
    instantiates, and the source's shared-memory sizes and launch bounds are
    the plan's."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
           / "ssd_scan_bwd.cu").read_text()
    inst = set(re.findall(r"launch<(float|__nv_bfloat16), (\d+)>", src))
    names = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}
    seen = set()
    for dtype in names:
        for ds in range(8, 129, 8):
            for hd in range(8, 65, 8):
                seen.add((names[dtype], str(bwd_launch_plan(dtype, hd, ds, 256).state_pad)))
    assert seen == inst
    assert "kStages = kBf ? 2 : 1" in src and "kLocalStages = kBf ? 3 : 2" in src
    assert "kTiles = kBf ? kState + 2 * kSBytes : (1 + kStages) * kPair" in src
    assert "kRowFloats = 2 * kT + 2 * kStages * kT + 4 * kT + 32" in src
    assert "kChunk = kTiles + 4 * kRowFloats + 1024" in src
    assert "kLocal = kLocalStages * (kPair + 4 * kT) + 1024" in src
    assert "kCB = 2 * kSBytes + 1024" in src
    assert f"kMaxChunk = {BWD_MAX_CHUNK};" in src
    assert "__launch_bounds__(kThreads, 2)\nssd_bwd_chunk" in src
    assert src.count("<<<") == BWD_KERNELS_PER_CALL[torch.float32]
    p = bwd_launch_plan(torch.bfloat16, 64, 128, 256)
    assert p.smem_chunk == 3 * 24576 + 2 * 16384 + 4 * (128 + 256 + 256 + 32) + 1024
    assert p.smem_local == 3 * (24576 + 256) + 1024
    big = bwd_launch_plan(torch.float32, 64, 128, BWD_MAX_CHUNK)
    assert big.smem_chunk == 2 * 49152 + 4 * (128 + 128 + 256 + 32) + 1024


@pytest.mark.parametrize("hd,ds,chunk,match", [
    (20, 16, 64, "head dim 20 is not a multiple of 8"),
    (64, 136, 64, "state size 136"),
    (64, 16, BWD_MAX_CHUNK + 1, f"chunk {BWD_MAX_CHUNK + 1} outside 1..{BWD_MAX_CHUNK}"),
])
def test_bwd_plan_refuses_what_it_cannot_tile(hd, ds, chunk, match):
    with pytest.raises(ValueError, match=match):
        bwd_launch_plan(torch.bfloat16, hd, ds, chunk)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        bwd_launch_plan(torch.float32, 64, 128, 256, seq=300)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bwd_launch_plan(torch.float16, 64, 128, 256)


# ------------------------------------------------------------ the autograd.Function

def _plain_for_grad(x, dt, A, B, C, D, *, chunk):
    """The kernel forward's outputs from the plain version; the plain
    backward recomputes what the kernel's keeps."""
    y, state = ssd_ref(x, dt, A, B, C, D, chunk=chunk)
    return y, state, None, None


def _plain_bwd(x, dt, A, B, C, D, dy, dstate, cs, s_in, *, chunk):
    return ssd_bwd_ref(x, dt, A, B, C, D, dy, dstate, chunk=chunk)


@pytest.fixture
def forced_cuda_route(monkeypatch):
    """``ssd_op`` routed as for CUDA tensors, its kernel entry points the
    plain versions; records what ran."""
    ran = []

    def rec(name, fn):
        def wrapped(*a, **kw):
            ran.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ssd_ops, "all_on_cpu", lambda *t: False)
    monkeypatch.setattr(ssd_ops, "ssd_scan", rec("forward", lambda *a, chunk: ssd_ref(
        *a, chunk=chunk)))
    monkeypatch.setattr(ssd_ops, "ssd_scan_for_grad", rec("forward for grad", _plain_for_grad))
    monkeypatch.setattr(ssd_ops, "ssd_scan_bwd", rec("backward", _plain_bwd))
    return ran


def _xbc_leaves(case, seed):
    """xBC (b, l, nh hd + 2 ds), dt, A, D as float32 leaves, and x, B, C as
    the mixer's views of xBC."""
    b, l, nh, hd, ds = case[:5]
    x, dt, A, B, C, D, dy, dS = _inputs(case, seed=seed)
    xbc = torch.from_numpy(np.concatenate([x.reshape(b, l, nh * hd), B, C], -1))
    leaves = [t.requires_grad_(True) for t in
              (xbc, torch.from_numpy(dt), torch.from_numpy(A), torch.from_numpy(D))]
    d_in = nh * hd
    views = (leaves[0][..., :d_in].reshape(b, l, nh, hd), leaves[1], leaves[2],
             leaves[0][..., d_in:d_in + ds], leaves[0][..., d_in + ds:], leaves[3])
    return leaves, views, torch.from_numpy(dy), torch.from_numpy(dS)


@pytest.mark.parametrize("use", ["y and state", "y", "state"])
def test_ssd_op_grads_through_xbc_views_on_the_cuda_route(forced_cuda_route, use):
    """Gradients of xBC, dt, A and D through ``_SsdScan`` equal autograd
    through the plain forward; an output the loss does not use reaches the
    backward as None (zeros for y, no state term for the state)."""
    case = CASES["four_chunks"]

    def grads(route):
        leaves, views, dy, dS = _xbc_leaves(case, seed=4)
        y, st = ssd_op(*views, chunk=case[5])
        loss = ((y * dy).sum() if "y" in use else 0) + ((st * dS).sum() if "state" in use
                                                        else 0)
        out = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, out)]

    got = grads("cuda")
    assert forced_cuda_route == ["forward for grad", "backward"]
    forced_cuda_route.clear()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(ssd_ops, "all_on_cpu", lambda *t: True)
        want = grads("cpu")
    assert forced_cuda_route == []
    for name, g, w in zip(("xBC", "dt", "A", "D"), got, want):
        if not w.any():  # D does not reach the final state
            assert use == "state" and name == "D" and not g.any()
            continue
        assert _rel(g, w) <= (DA_REL if name == "A" else F32_REL), name


def test_ssd_op_takes_the_inference_forward_without_grad(forced_cuda_route):
    leaves, views, _, _ = _xbc_leaves(CASES["one_chunk"], seed=5)
    with torch.no_grad():
        ssd_op(*views, chunk=64)
    ssd_op(*(v.detach() for v in views), chunk=64)
    assert forced_cuda_route == ["forward", "forward"]


def test_mamba2_train_step_on_the_cuda_route_equals_the_cpu_step(forced_cuda_route):
    """reduced mamba2-780m, b 2 x S 64 (two chunks of 32): one train step
    through ``_SsdScan`` (plain entry points) against the CPU's autograd
    through ``ssd_ref``; AdamW eps 1, so that updated parameters compare the
    gradients and not the sign-like first update of near-zero entries."""
    cfg = reduced(get_config("mamba2-780m"))
    model = build_model(cfg)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=10, eps=1.0)
    rng = np.random.default_rng(6)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 65), dtype=np.int32))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    step = make_train_step(model, opt)
    forced, m_forced = step(make_train_state(model, opt, 0, device="cpu"), batch)
    assert forced_cuda_route.count("backward") == cfg.num_layers
    forced_cuda_route.clear()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(ssd_ops, "all_on_cpu", lambda *t: True)
        cpu, m_cpu = step(make_train_state(model, opt, 0, device="cpu"), batch)
    assert forced_cuda_route == []
    assert abs(float(m_forced["loss"]) - float(m_cpu["loss"])) <= 1e-6 * abs(float(m_cpu["loss"]))
    assert abs(float(m_forced["grad_norm"]) - float(m_cpu["grad_norm"])) <= \
        1e-5 * float(m_cpu["grad_norm"])
    want = dict(flat_tensors(cpu["params"]))
    for path, t in flat_tensors(forced["params"]):
        w = want[path]
        assert float((t - w).abs().max()) <= 1e-5 * float(w.abs().max()) + 1e-8, path
