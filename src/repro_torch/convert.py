"""Parameters between the port's tensors and the snapshot engine's numpy.

The machine with the card has no ``ml_dtypes``, so numpy has no bfloat16
there.  The port's rule: a bfloat16 leaf crosses into numpy (the registry,
the chunk store, source artifacts) as its ``uint16`` bit pattern, and is
reinterpreted back to ``torch.bfloat16`` at the worker boundary from the
model template's dtype.  The bytes are those of the JAX package's leaves,
so chunk digests are identical; the manifests name the leaf ``uint16``.
The snapshot core is copied verbatim.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device

PyTree = Any


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of ``t``; bfloat16 becomes its ``uint16`` bit pattern.

    Always a copy, also of a CPU tensor: the optimizer updates its tensors
    in place, and an async checkpoint hashes this array after the next step
    has begun."""
    t = torch.empty(t.shape, dtype=t.dtype, device="cpu").copy_(t.detach())
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_tensor(arr: np.ndarray, dtype: torch.dtype, device: DeviceLike) -> torch.Tensor:
    """A new tensor on ``device`` holding ``arr``'s bytes as ``dtype``.

    ``arr`` may be read-only (pooled restore buffers are); the result never
    aliases it.  For a bfloat16 target ``arr`` holds 2-byte bit patterns
    (``uint16``, or ``ml_dtypes.bfloat16`` from the JAX package)."""
    a = np.ascontiguousarray(arr).reshape(np.shape(arr))  # keeps a 0-d array 0-d
    if dtype == torch.bfloat16:
        if a.dtype.itemsize != 2:
            raise TypeError(f"bfloat16 needs 2-byte bit patterns, got {a.dtype}")
        a = a.view(np.int16)
    with warnings.catch_warnings():
        # read-only buffers: the tensor is only read, then copied below
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a)
    t = t.to(resolve_device(device), copy=True)
    if dtype == torch.bfloat16:
        return t.view(torch.bfloat16)
    if t.dtype != dtype:
        raise TypeError(f"array of {a.dtype} does not hold {dtype}")
    return t


def flat_tensors(tree: PyTree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """Nested dict of tensors → ``[("a/b/c", tensor), ...]`` in sorted key
    order, as ``flatten_pytree`` orders them (no copies)."""
    if isinstance(tree, dict):
        return [pt for k in sorted(tree) for pt in flat_tensors(tree[k], f"{prefix}{k}/")]
    return [] if tree is None else [(prefix[:-1], tree)]


def params_to_flat(params: PyTree) -> Dict[str, np.ndarray]:
    """Nested dict of tensors → ``{"a/b/c": ndarray}`` host copies with
    sorted keys, as ``flatten_pytree`` orders them."""
    return {path: to_numpy(t) for path, t in flat_tensors(params)}


def train_state_to_flat(state: PyTree) -> Dict[str, np.ndarray]:
    """A train state ``{"params", "opt": {"m", "v", "step"}}`` (AdamW) or
    ``{"params", "opt": {"v": {... {"vr", "vc"} | {"v"}}, "step"}}``
    (Adafactor) → host copies at JAX's flat paths (``opt/m/embed/table``,
    ``opt/step``, ``params/...``), as the JAX trainer checkpoints it."""
    return params_to_flat(state)


def train_state_from_numpy(flat: Dict[str, np.ndarray], device: DeviceLike = None, *,
                           template: PyTree) -> PyTree:
    """The inverse of :func:`train_state_to_flat`, also for a JAX train
    state's ``flatten_pytree``: ``template`` is
    ``launch.steps.train_state_shapes(model, opt_cfg)``, whose dtypes turn
    bfloat16 bit patterns back into bfloat16.  Every leaf of the template
    must be in ``flat``."""
    missing = sorted({path for path, _ in flat_tensors(template)} - set(flat))
    if missing:
        raise KeyError(f"train state leaves missing from the snapshot: {missing[:5]}")
    return params_from_flat(flat, device, template=template)


def _leaf_dtype(arr: np.ndarray) -> torch.dtype:
    if arr.dtype.name == "bfloat16":  # ml_dtypes, from the JAX package
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, arr.dtype)).dtype


def params_from_flat(flat: Dict[str, np.ndarray], device: DeviceLike = None, *,
                     template: Optional[PyTree] = None) -> PyTree:
    """``{"a/b/c": ndarray}`` (e.g. ``flatten_pytree`` of JAX parameters) →
    the port's nested dict of tensors on ``device``.

    With ``template`` (``Model.param_shapes()``) every leaf takes the
    template's dtype and shape, which turns the ``uint16`` bit patterns of
    :func:`params_to_flat` back into bfloat16: the two are inverse.  A JAX
    decode cache crosses the same way, with
    ``template=model.init_cache(batch, cache_len, device="meta")``."""
    root: Dict[str, Any] = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node, tnode = root, template
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            tnode = tnode[p] if tnode is not None else None
        leaf_t = tnode[parts[-1]] if tnode is not None else None
        if leaf_t is not None and tuple(leaf_t.shape) != tuple(arr.shape):
            raise ValueError(f"{path}: shape {arr.shape} != template {tuple(leaf_t.shape)}")
        dtype = leaf_t.dtype if leaf_t is not None else _leaf_dtype(arr)
        node[parts[-1]] = to_tensor(arr, dtype, device)
    return root


# -- bfloat16 bit patterns as values (numpy, no ml_dtypes) ---------------------

def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """Round float32 to bfloat16 (nearest, ties to even), as bit patterns."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = (u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))) >> 16
    nan = np.isnan(x)
    out = rounded.astype(np.uint16)
    if nan.any():
        out[nan] = ((u[nan] >> 16) | np.uint32(0x40)).astype(np.uint16)
    return out
