"""What every kernel wrapper of the port shares: a thread-safe launch
counter (``obs.LaunchCounter``, registered by the kernel's name), the
check of the C launcher's return code, the card's SM count, and the meta
route of the dry run.

A wrapper sees one of three device kinds: the CPU (the plain version),
CUDA (the kernel) and ``meta`` (the dry run, ``launch/dryrun.py``).  On
meta, flash attention and the SSD scan take the CUDA branch, allocate their
outputs on meta, book one call of the kernel (its operations and bytes) with
every cost ledger open in the context (``opcost.CostMode``), and launch
nothing: the launch counters stay as they are."""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Any, Dict, Iterator, Tuple

import torch

from ..obs import LaunchCounter  # noqa: F401

_sms: Dict[int, int] = {}
_LEDGERS: ContextVar[Tuple[Any, ...]] = ContextVar("repro_torch_cost_ledgers", default=())


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
                f"{kernel}: every tensor must lie on one CUDA device, got devices "
                f"{[str(x.device) for x in tensors]}")
    return dev


def launch_device(kernel: str, *tensors: torch.Tensor) -> torch.device:
    """The device a kernel with a meta route runs on: one CUDA device for
    all tensors, or ``meta`` for all (the dry run); raises otherwise."""
    if all(t.device.type == "meta" for t in tensors):
        return tensors[0].device
    return require_cuda(kernel, *tensors)


def all_on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain-version route);
    False when all lie on CUDA or all on meta (the kernel's route); raises
    on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds in ({"cuda"}, {"meta"}):
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(kinds)}")


@contextlib.contextmanager
def ledger_open(ledger: Any) -> Iterator[Any]:
    """While open, every booking of the meta route goes to
    ``ledger.book_kernel(kernel, ops, nbytes)``."""
    token = _LEDGERS.set(_LEDGERS.get() + (ledger,))
    try:
        yield ledger
    finally:
        _LEDGERS.reset(token)


def book(kernel: str, ops: float, nbytes: int) -> None:
    """One call of ``kernel`` on the meta route: its operations and the
    bytes it moves, to every open ledger (none: the call is not counted)."""
    for ledger in _LEDGERS.get():
        ledger.book_kernel(kernel, ops, nbytes)


def sm_count(dev: torch.device) -> int:
    """The SMs of a CUDA device, read once per device."""
    n = _sms.get(dev.index)
    if n is None:
        n = _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n
