"""A bfloat16 snapshot written by the JAX package, restored through the
port's copy of ``core/`` where ``ml_dtypes`` cannot be imported (as on the
machine with the card): the JAX manifests name such leaves ``"bfloat16"``,
which numpy resolves only through ``ml_dtypes`` or the port's registration
of the name as the 2-byte bit pattern.

The JAX package's capture reads a leaf through ``memoryview``, which numpy
refuses for an ``ml_dtypes`` array, so the test captures each bfloat16
leaf's bits (the chunk digests are the same) and records the dtype the
JAX package records for the leaf, ``str(arr.dtype)``: ``"bfloat16"``."""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.chunkstore import ChunkStore
from repro.core.restore import BasePool, restore_layered
from repro.core.snapshot import take_diff_snapshot, take_snapshot

ROOT = pathlib.Path(__file__).resolve().parents[1]

CHILD = r"""
import sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
import numpy as np
try:
    np.dtype("bfloat16")
    raise SystemExit("numpy resolved bfloat16 without ml_dtypes or the port")
except TypeError:
    pass
import torch
from repro_torch.convert import to_tensor
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.restore import BasePool, restore_layered
from repro_torch.core.snapshot import SnapshotManifest
root, out = sys.argv[1], sys.argv[2]
assert np.dtype("bfloat16").itemsize == 2
store = ChunkStore(root)
base = SnapshotManifest.load(root, "base")
diff = SnapshotManifest.load(root, "diff")
pool = BasePool.load(store, base)
inst = restore_layered(store, base, diff, pool, function="fn")
got = {}
for path, meta in diff.arrays.items():
    arr = inst.value(path)
    dtype = torch.bfloat16 if meta.dtype == "bfloat16" else torch.float32
    t = to_tensor(arr, dtype, "cpu")
    assert t.dtype == dtype and tuple(t.shape) == tuple(meta.shape)
    got["pool/" + path] = to_tensor(pool.get(path), dtype, "cpu").reshape(-1).view(torch.uint8).numpy()
    got["inst/" + path] = t.reshape(-1).view(torch.uint8).numpy()
np.savez(out, **{k.replace("/", "|"): v for k, v in got.items()})
print("OK")
"""


def _tree(rng, scale=1.0):
    return {
        "embed": {"table": jnp.asarray(rng.standard_normal((300, 64)) * scale, jnp.bfloat16)},
        "layer": {"w": jnp.asarray(rng.standard_normal((64, 96)) * scale, jnp.bfloat16),
                  "norm": jnp.asarray(rng.standard_normal((64,)), jnp.float32)},
    }


def _bits(tree):
    """The flat leaves, bfloat16 ones as their uint16 bits."""
    return {f"{k}/{n}": (a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
            for k, v in tree.items() for n, a in v.items()}


def _recorded(manifest, tree):
    """``manifest`` with each leaf's dtype as the JAX package records it."""
    for k, v in tree.items():
        for n, a in v.items():
            manifest.arrays[f"{k}/{n}"].dtype = str(a.dtype)
    return manifest


@pytest.mark.parametrize("chunk_bytes", [4096, 256 * 1024])
def test_jax_bf16_manifest_restores_without_ml_dtypes(tmp_path, chunk_bytes):
    """Base and diff snapshots of bfloat16 and float32 leaves, saved by the
    JAX package; a subprocess with ``ml_dtypes`` and ``jax`` blocked loads
    both manifests, restores the base pool and the layered instance through
    the port's core, turns every leaf into a tensor of the manifest's dtype,
    and its bytes equal the JAX package's restore."""
    root = str(tmp_path / "store")
    rng = np.random.default_rng(chunk_bytes)
    base_tree = {k: {n: np.asarray(a) for n, a in v.items()} for k, v in _tree(rng).items()}
    var = {k: dict(v) for k, v in base_tree.items()}
    var["layer"]["w"] = np.asarray(jnp.asarray(var["layer"]["w"], jnp.float32) * 1.5,
                                   jnp.bfloat16)
    store = ChunkStore(root)
    base = _recorded(take_snapshot(store, "base", _bits(base_tree), chunk_bytes=chunk_bytes),
                     base_tree)
    base.save(root)
    diff = _recorded(take_diff_snapshot(store, "diff", _bits(var), base), var)
    diff.save(root)
    assert diff.arrays["embed/table"].dtype == "bfloat16"
    assert diff.arrays["layer/norm"].dtype == "float32"
    pool = BasePool.load(store, base)
    inst = restore_layered(store, base, diff, pool, function="fn")

    out = tmp_path / "port.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", CHILD, root, str(out)], capture_output=True,
                       text=True, env=env, cwd=str(ROOT), timeout=600)
    assert r.returncode == 0, r.stderr[-3000:] + r.stdout[-1000:]
    assert r.stdout.strip().endswith("OK")
    got = {k.replace("|", "/"): v for k, v in np.load(out).items()}
    for path in diff.arrays:
        want = np.ascontiguousarray(inst.value(path)).view(np.uint8).ravel()
        np.testing.assert_array_equal(got["inst/" + path], want, err_msg=path)
        np.testing.assert_array_equal(
            got["pool/" + path], np.ascontiguousarray(pool.get(path)).view(np.uint8).ravel(),
            err_msg=path)
    # the variant's bytes, not the base's, where the diff changed the leaf
    w = np.ascontiguousarray(var["layer"]["w"]).view(np.uint8).ravel()
    np.testing.assert_array_equal(got["inst/layer/w"], w)
