"""Guards of the PyTorch port (``src/repro_torch``): it imports neither JAX
nor the JAX package, its copied modules stay copies, and its entry points
refuse to run on a host without a GPU unless asked for the CPU."""

import ast
import difflib
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
JAXPKG = SRC / "repro"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_port_imports_without_jax_or_ml_dtypes():
    """Every module of the port imports with ``jax`` and ``ml_dtypes``
    blocked, and none of them pulls in the JAX package."""
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = [k for k in sys.modules if k == "repro" or k.startswith("repro.")]
assert not bad, bad
print("OK", len(names))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK")
    assert int(r.stdout.split()[1]) >= 40  # the whole package was walked


def _bad_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            arg = node.args[0]
            head = arg.value if isinstance(arg, ast.Constant) else (
                arg.values[0].value if arg.values and isinstance(arg.values[0], ast.Constant) else "")
            names = [str(head)]
        for n in names:
            if n == "jax" or n.startswith("jax.") or n == "repro" or n.startswith("repro."):
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno}: {n}")
    return bad


EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
# the dry run's example allocates on no device: it runs without a GPU
DEVICE_EXAMPLES = [p for p in EXAMPLES if p.name != "torch_multipod_dryrun.py"]


def test_no_jax_or_repro_imports_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
    assert len(files) > 40
    assert len(EXAMPLES) == 4 and len(DEVICE_EXAMPLES) == 3
    bad = [b for f in files for b in _bad_imports(f)]
    assert not bad, bad


def test_chip_smoke_imports_nothing_of_the_jax_package():
    assert _bad_imports(ROOT / "chip_smoke.py") == []
    assert "import repro\n" not in (ROOT / "chip_smoke.py").read_text()


# modules the port carries as copies of the JAX package's numpy-only ones
COPIED = (
    [f"core/{p.name}" for p in sorted((JAXPKG / "core").glob("*.py"))]
    + [f"configs/{p.name}" for p in sorted((JAXPKG / "configs").glob("*.py"))]
    + ["models/config.py", "models/blocks.py", "data/__init__.py", "data/pipeline.py"]
    + [f"serving/{m}.py" for m in
       ("__init__", "api", "policy", "admission", "scheduler", "loadgen", "cluster")]
)

# the one intended divergence: the cluster hands its device to the workers
ALLOWED_EXTRA = {
    "serving/cluster.py": [
        "        device: Optional[str] = None,",
        "        self._device = device",
        "                device=device,",
        "            device=self._device,",
    ],
}


# functions of the distribution layer, the launch specs and the cost model
# the port carries verbatim (docstrings and the port's late imports aside):
# module, qualified name, and the JAX package's module where it differs
VERBATIM = [
    ("distrib/sharding.py", "Rules.model_if", None),
    ("distrib/sharding.py", "Rules.batch_if", None),
    ("distrib/sharding.py", "Rules.layer_specs", None),
    ("distrib/sharding.py", "Rules.param_specs", None),
    ("distrib/sharding.py", "Rules.batch_specs", None),
    ("distrib/sharding.py", "Rules.cache_specs", None),
    ("distrib/act.py", "current_binding", None),
    ("distrib/act.py", "default_rules", None),
    ("launch/specs.py", "dec_len", None),
    ("launch/specs.py", "opt_for", None),
    ("launch/specs.py", "train_sharding", None),
    ("launch/specs.py", "microbatch_seqs", None),
    ("launch/specs.py", "remat_group_for", None),
    ("roofline.py", "model_flops", None),
    ("opcost.py", "_wire_bytes", "hlocost.py"),
]


def _function_body(path: pathlib.Path, qualname: str) -> str:
    tree = ast.parse(path.read_text())
    node = tree
    for part in qualname.split("."):
        node = next(n for n in ast.iter_child_nodes(node)
                    if isinstance(n, (ast.ClassDef, ast.FunctionDef)) and n.name == part)
    body = [b for b in node.body
            if not isinstance(b, (ast.Import, ast.ImportFrom))
            and not (isinstance(b, ast.Expr) and isinstance(b.value, ast.Constant))]
    return "\n".join(ast.unparse(b) for b in body)


@pytest.mark.parametrize("rel,qualname,jax_rel", VERBATIM,
                         ids=[f"{r}:{q}" for r, q, _ in VERBATIM])
def test_verbatim_function_has_not_drifted(rel, qualname, jax_rel):
    assert (_function_body(PORT / rel, qualname)
            == _function_body(JAXPKG / (jax_rel or rel), qualname))


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_has_not_drifted(rel):
    """The copy equals its original once the package name is normalised
    (so only import lines may differ), plus the allowed additions."""
    orig = (JAXPKG / rel).read_text().splitlines()
    port = (PORT / rel).read_text().replace("repro_torch", "repro").splitlines()
    delta = [d for d in difflib.ndiff(orig, port) if d[:2] in ("- ", "+ ")]
    removed = [d[2:] for d in delta if d.startswith("- ")]
    added = [d[2:] for d in delta if d.startswith("+ ")]
    assert removed == [], removed
    assert added == ALLOWED_EXTRA.get(rel, []), added


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serving import Worker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Worker(str(tmp_path / "w"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Worker(str(tmp_path / "w"), device="cuda")
    model = build_model(reduced(get_config("stablelm-3b")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    assert Worker(str(tmp_path / "c"), device="cpu").device.type == "cpu"


def test_replay_cli_needs_a_gpu_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    from repro_torch.launch import replay

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            replay.main(argv + ["--root", str(tmp_path / "r"), "--duration", "0.1"])


@pytest.mark.parametrize("example", [p.name for p in DEVICE_EXAMPLES])
def test_example_needs_a_gpu_unless_asked_for_the_cpu(example):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(ROOT / "examples" / example)], capture_output=True,
                       text=True, env=env, cwd=str(ROOT), timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stdout + r.stderr


def test_chip_smoke_fails_without_gpu_and_alone(tmp_path):
    """No GPU → non-zero exit and no result line; the same for the script
    copied into a directory with nothing else of the repository."""
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                       text=True, env=env, cwd=str(ROOT), timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                       text=True, env=env, cwd=str(alone), timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
