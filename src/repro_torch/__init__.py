"""PyTorch / CUDA port of the snapshot cold-start serving stack.

The JAX package ``repro`` is the reference; this package runs the same main
path — content-addressed snapshot restore, on-device base ⊕ diff patching and
the dense and SSM forward behind ``Worker.invoke`` — and prefill and decode
on an NVIDIA H100, with the TPU kernels (``snapshot_patch``,
``flash_attention``, ``ssd_scan``, ``decode_attention_int8``) rewritten by
hand in CUDA C++ for ``sm_90a`` (``csrc/``).  It imports ``torch`` and numpy only:
modules it shares with ``repro`` are copies, held to their originals by a
drift test.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (:func:`resolve_device`).
"""

import numpy as _np

from .device import resolve_device

try:  # registers numpy's "bfloat16", the name the JAX package's manifests record
    import ml_dtypes  # noqa: F401
except ImportError:
    # Without it (the machine with the card has none), a manifest's
    # "bfloat16" resolves to the leaf's 2-byte bit pattern, the form in which
    # the port carries bfloat16 through numpy (convert.py), so the copied
    # core reads a JAX-written bfloat16 snapshot unchanged.
    _np.sctypeDict.setdefault("bfloat16", _np.uint16)

__all__ = ["resolve_device"]
