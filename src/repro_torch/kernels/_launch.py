"""What every kernel wrapper of the port shares: a thread-safe launch
counter, the check of the C launcher's return code and the card's SM
count."""

from __future__ import annotations

import threading
from typing import Dict

import torch

_sms: Dict[int, int] = {}


class LaunchCounter:
    """Launches of one kernel.  The cluster runs workers on threads, so the
    count is taken under a lock."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


def check_launch(kernel: str, rc: int) -> None:
    """``rc`` is the ``cudaGetLastError`` the launcher returned: a refused
    launch never runs, and a later synchronise would not report it."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def require_cuda(kernel: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device; returns it."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(
                f"{kernel}: every tensor must lie on one CUDA device, got "
                f"{[str(x.device) for x in tensors]}")
    return dev


def all_on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain-version route);
    False when all lie on CUDA; raises on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(kinds)}")


def sm_count(dev: torch.device) -> int:
    """The SMs of a CUDA device, read once per device."""
    n = _sms.get(dev.index)
    if n is None:
        n = _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n
