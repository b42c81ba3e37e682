"""Cost of one traced step: FLOPs, bytes, kernel calls and collectives.  The
port's counterpart of ``repro.hlocost``, which reads the optimized HLO of a
compiled module; the port has no compiler to ask, so it walks the step
itself.

``CostMode`` is a ``TorchDispatchMode``: the step runs once on the meta
device (global shapes, nothing allocated), and every aten op it dispatches,
the backward's included, is counted as it goes:

* FLOPs: the matmul formulas ``torch.utils.flop_counter`` registers (mm,
  bmm, addmm, baddbmm, convolution, ...), 2·M·N·K as hlocost counts a
  ``dot``; elementwise ops count none (as in hlocost: ≤1 % of a transformer
  step);
* bytes: the output bytes of every op that is not a view, not an
  ``empty`` that writes nothing and not a host constant lifted into a
  tensor: hlocost's HBM-traffic proxy (materialised output bytes of every
  real op; constants are plumbing), with in-place ops counting the bytes
  they write;
* kernels: flash attention and the SSD scan, forward and backward, book
  their calls on the meta route (``kernels/_launch.py``) with their own
  operations and bytes, the formulas of ``chip_smoke.py``'s bound column;
  they are added to the totals and kept per kernel (``kernel_calls``);
* live bytes: every storage a functional op allocates inside the mode is
  held by a weak reference and counted until it is freed, so the peak of
  what the step allocates (activations, gradients, temporaries) is known;
  in-place updates of the arguments allocate nothing.

Work that the sharded step repeats on several devices, where the traced
global step runs it once, is counted that many times inside ``repeated(n)``
(the MoE FFN of the serving layout, ``launch/specs.py``).

No partitioner inserts collectives into the port's step: the model of what
the sharded step sends is stated in ``launch/collectives.py``.  The totals
add them per device as hlocost counts them (``add_collectives``: wire bytes
by ``_wire_bytes``'s ring factors, counts and bytes by op), and
``roofline.analyze`` times them at their axes' link rates.
"""

from __future__ import annotations

import contextlib
import weakref
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .kernels import _launch

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
#: allocations that write nothing: live bytes, no traffic
_EMPTY = {_aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
          _aten.new_empty_strided}
#: a host array lifted into a tensor (``torch.from_numpy``: whisper's
#: positions table) before it is copied over: hlocost's "constant" plumbing
_CONSTANTS = {_aten.lift_fresh, _aten.lift_fresh_copy}
#: how many devices run the work being traced (``repeated``)
_REPEAT: ContextVar[int] = ContextVar("repro_torch_cost_repeat", default=1)


@contextlib.contextmanager
def repeated(n: int) -> Iterator[None]:
    """While open, the FLOPs and bytes that every ``CostMode`` counts (its
    ops and kernel bookings) are counted ``n`` times over: work that the
    sharded step repeats on ``n`` devices, where the global trace runs it
    once.  Only what runs inside counts so: a backward that autograd runs
    later is counted once."""
    token = _REPEAT.set(_REPEAT.get() * n)
    try:
        yield
    finally:
        _REPEAT.reset(token)


def _wire_bytes(op: str, nbytes: int, n: int) -> float:
    if op == "all-gather":
        return nbytes * (n - 1) / n
    if op == "reduce-scatter":
        return nbytes * (n - 1)
    if op == "all-reduce":
        return 2 * nbytes * (n - 1) / n
    if op == "all-to-all":
        return nbytes * (n - 1) / n
    return float(nbytes)  # collective-permute


@dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0
    collective_counts: Dict[str, int] = field(default_factory=dict)
    collective_bytes: Dict[str, int] = field(default_factory=dict)
    kernel_calls: Dict[str, int] = field(default_factory=dict)
    kernel_flops: Dict[str, float] = field(default_factory=dict)
    kernel_bytes: Dict[str, float] = field(default_factory=dict)
    #: the most bytes the traced step held allocated at once
    peak_live_bytes: int = 0
    #: device type of every op output that holds bytes -> the first op that
    #: wrote there (a dry run: only "meta")
    devices: Dict[str, str] = field(default_factory=dict)

    def add_collectives(self, colls: Sequence[Any]) -> None:
        """Adds ``colls`` (``launch.collectives.Collective``: ``op``,
        ``nbytes``, ``count``, ``wire_bytes``), per device."""
        for c in colls:
            self.wire_bytes += c.wire_bytes
            self.collective_counts[c.op] = self.collective_counts.get(c.op, 0) + c.count
            self.collective_bytes[c.op] = (self.collective_bytes.get(c.op, 0)
                                           + c.nbytes * c.count)

    def per_device(self, n: int, colls: Sequence[Any] = ()) -> "CostTotals":
        """A cell's per-device totals: the traced global step's FLOPs, bytes
        and peak live bytes split evenly over ``n`` devices, plus the
        collectives (already per device)."""
        t = CostTotals(flops=self.flops / n, bytes=self.bytes / n,
                       kernel_calls=dict(self.kernel_calls),
                       peak_live_bytes=self.peak_live_bytes // n, devices=dict(self.devices))
        t.add_collectives(colls)
        return t


class CostMode(TorchDispatchMode):
    """Counts the ops of everything run while it is open, and the kernel
    calls booked on the meta route.  ``totals`` is a ``CostTotals``;
    ``read`` the ids of the ``watch`` tensors some op took as an input."""

    def __init__(self, watch: Sequence[torch.Tensor] = ()) -> None:
        super().__init__()
        self.totals = CostTotals()
        self.read: set = set()
        self._watch = {id(t) for t in watch}
        self._live = 0
        self._held: Dict[int, Any] = {}   # id(storage) -> its finalizer

    def __enter__(self):
        self._ledger = _launch.ledger_open(self)
        self._ledger.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._ledger.__exit__(*exc)

    def book_kernel(self, kernel: str, ops: float, nbytes: int) -> None:
        t, n = self.totals, _REPEAT.get()
        ops, nbytes = ops * n, nbytes * n
        t.flops += ops
        t.bytes += nbytes
        t.kernel_calls[kernel] = t.kernel_calls.get(kernel, 0) + 1
        t.kernel_flops[kernel] = t.kernel_flops.get(kernel, 0.0) + ops
        t.kernel_bytes[kernel] = t.kernel_bytes.get(kernel, 0.0) + nbytes

    def _freed(self, key: int, nbytes: int) -> None:
        self._held.pop(key, None)
        self._live -= nbytes

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        nbytes = st.nbytes()
        self._held[key] = weakref.finalize(st, self._freed, key, nbytes)
        self._live += nbytes
        self.totals.peak_live_bytes = max(self.totals.peak_live_bytes, self._live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._watch:
            self.read.update(id(a) for a in tree_leaves((args, kwargs))
                             if id(a) in self._watch)
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in _CONSTANTS:
            return out
        n = _REPEAT.get()
        formula = flop_registry.get(packet)
        if formula is not None:
            self.totals.flops += formula(*args, **kwargs, out_val=out) * n
        outs = [t for t in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(t, torch.Tensor)]
        for t in outs:
            if t.numel():  # checkpoint's empty CPU anchor holds no bytes
                self.totals.devices.setdefault(t.device.type, str(func))
        if not func.is_view:
            if packet not in _EMPTY:
                self.totals.bytes += sum(t.numel() * t.element_size() for t in outs) * n
            if not func._schema.is_mutable:  # an in-place op allocates nothing
                for t in outs:
                    self._hold(t)
        return out


def trace(fn, *args) -> Tuple[Any, CostTotals, set]:
    """Run ``fn(*args)`` under a ``CostMode``; returns (its result, the
    totals, the ids of the tensors of ``args`` that some op read)."""
    with CostMode(watch=[a for a in tree_leaves(args) if isinstance(a, torch.Tensor)]) as mode:
        result = fn(*args)
    return result, mode.totals, mode.read
