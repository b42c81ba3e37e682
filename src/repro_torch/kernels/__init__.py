"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each beside
its plain PyTorch version:

* snapshot_patch  — fused base ⊕ diff restore (replaces the Pallas
  ``patch_apply``)
* flash_attention — online-softmax attention, GQA / MQA, causal, sliding
  window, softcap (replaces the Pallas ``flash_attention``)

A wrapper launches its kernel for CUDA tensors and takes the plain version
only for tensors on the CPU; it never falls back from one to the other.
"""
