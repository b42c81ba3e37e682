"""The AST invariant analyzer (``python -m repro.analysis``) over the
PyTorch port, gated on the port's own baseline
(``src/repro_torch/analysis-baseline.json``, empty): the port must stay
free of findings, and a new one fails the gate."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BASELINE = PORT / "analysis-baseline.json"


def _analyze(root: pathlib.Path, *extra: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "repro.analysis", "--root", str(root),
         "--baseline", str(BASELINE), "--fail-on-new", *extra],
        capture_output=True, text=True, cwd=str(ROOT), timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_port_baseline_is_empty():
    assert json.loads(BASELINE.read_text()) == {"version": 1, "findings": []}


def test_port_has_no_new_findings():
    r = _analyze(PORT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 new" in r.stdout, r.stdout


def test_port_findings_as_json_are_empty():
    r = _analyze(PORT, "--format", "json")
    assert r.returncode == 0, r.stdout + r.stderr
    assert json.loads(r.stdout)["summary"]["total"] == 0


@pytest.mark.parametrize("marker", ["# broad-ok:"])
def test_gate_fails_on_an_unmarked_broad_except(tmp_path, marker):
    """Control: the checkpoint writer's broad except without its reason is
    a new finding, and the gate exits 1 naming it."""
    copy = tmp_path / "repro_torch"
    shutil.copytree(PORT, copy, ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    trainer = copy / "train" / "trainer.py"
    src = trainer.read_text()
    assert marker in src
    trainer.write_text(src.replace(marker, "#"))
    r = _analyze(copy)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "train/trainer.py" in r.stdout and "E2" in r.stdout, r.stdout
