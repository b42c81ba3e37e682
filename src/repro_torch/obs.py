"""The port's recorder of host spans and counters: off unless enabled.

``span(name)`` marks one stretch of host time on the request path;
``request(name)`` marks the root of one request (``Worker.invoke``) and
draws its id from a process-wide counter.  Off, the default, both return
one shared context that does nothing, after a single check of a module
flag.  On (``enable()``), a span records its name, the id of the request
whose root encloses it, its parent span's id, its thread, its attributes,
and its start and end on ``time.perf_counter_ns``'s clock: the clock a
device trace is anchored to by a marker taken with ``time.perf_counter``.
Spans stay in a list per thread, appended without a lock, until
``drain()`` hands them over.

``LaunchCounter`` is the one counter type.  Every kernel wrapper counts
its launches with one; the worker counts the bytes it copies to the
device and its device-wide waits with one, the kernel loader the
libraries it loads.  Every counter is registered here by its name, and
``drain()`` returns how far each moved since ``enable()`` (or the last
``drain()``).

Nothing here imports torch, and no span synchronises or copies: the
recorder reads the host's clock and nothing else.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional


class LaunchCounter:
    """A count (launches, bytes, waits) that threads add to under a lock,
    registered with the recorder by its name: the recorder reports how far
    it moved while recording."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._n = 0
        self._lock = threading.Lock()
        with _lock:
            _counters[name] = self

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


class Span(NamedTuple):
    """One closed span; times are ``time.perf_counter_ns()``."""

    id: int
    parent: Optional[int]        # the enclosing span on the same thread
    request: Optional[int]       # the enclosing ``request`` span's request id
    thread: int                  # ``threading.get_ident()``
    name: str
    start_ns: int
    end_ns: int
    attrs: Dict[str, Any]


class _Thread:
    """One thread's open spans and closed ones."""

    __slots__ = ("thread", "tid", "stack", "spans")

    def __init__(self) -> None:
        self.thread = threading.current_thread()
        self.tid = threading.get_ident()
        self.stack: List[_Open] = []
        self.spans: List[Span] = []


class _Off:
    """What ``span`` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


class _Open:
    __slots__ = ("name", "attrs", "root", "id", "parent", "request", "start", "st")

    def __init__(self, name: str, attrs: Dict[str, Any], root: bool) -> None:
        self.name, self.attrs, self.root = name, attrs, root

    def __enter__(self) -> "_Open":
        st = _thread_state()
        up = st.stack[-1] if st.stack else None
        self.id = next(_span_ids)
        self.parent = up.id if up is not None else None
        self.request = (next(_request_ids) if self.root
                        else up.request if up is not None else None)
        self.st = st
        st.stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        st = self.st
        st.stack.pop()
        st.spans.append(Span(self.id, self.parent, self.request, st.tid, self.name,
                             self.start, end, self.attrs))
        return False

    def set(self, **attrs: Any) -> None:
        """Attributes known only inside the span (a request's ``cold``)."""
        self.attrs.update(attrs)


_on = False
_OFF = _Off()
_lock = threading.Lock()
_counters: Dict[str, LaunchCounter] = {}
_base: Dict[str, int] = {}          # each counter's value at enable() / the last drain()
_threads: List[_Thread] = []
_local = threading.local()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)


def _thread_state() -> _Thread:
    st = getattr(_local, "st", None)
    if st is None:
        st = _local.st = _Thread()
        with _lock:
            _threads.append(st)
    return st


def _values() -> Dict[str, int]:
    return {name: c.value for name, c in _counters.items()}


def span(name: str, **attrs: Any):
    """A context manager around one stretch of host time."""
    if not _on:
        return _OFF
    return _Open(name, attrs, False)


def request(name: str, **attrs: Any):
    """``span`` for the root of a request: it and every span inside it on
    its thread carry a new request id."""
    if not _on:
        return _OFF
    return _Open(name, attrs, True)


def enable() -> None:
    """Start recording: spans closed before now and counts taken before
    now are not reported."""
    global _on
    with _lock:
        for st in _threads:
            st.spans = []
        _base.clear()
        _base.update(_values())
        _on = True


def disable() -> None:
    global _on
    _on = False


def drain() -> Dict[str, Any]:
    """``{"spans": [Span, ...] by start, "counters": {name: difference}}``
    since ``enable()`` or the last ``drain()``, and clear them.  Take it
    once the recorded threads are quiet: a span that closes while the
    lists are handed over may be lost."""
    with _lock:
        spans: List[Span] = []
        for st in _threads:
            got, st.spans = st.spans, []
            spans.extend(got)
        _threads[:] = [st for st in _threads if st.thread.is_alive()]
        now = _values()
        counters = {name: v - _base.get(name, 0) for name, v in now.items()}
        _base.clear()
        _base.update(now)
    spans.sort(key=lambda s: (s.start_ns, s.id))
    return {"spans": spans, "counters": counters}
