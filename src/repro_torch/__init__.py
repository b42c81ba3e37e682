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

from .device import resolve_device

__all__ = ["resolve_device"]
