"""The port's tracer: named host spans on the profiler's clock.

``span(name, step=None, **attrs)`` marks a stretch of host work: its name,
the span it is nested in (the innermost open span on the same thread), a
step id, its start and end by ``time.time_ns()`` and any attributes.  While
it records, it also opens a ``torch.profiler.record_function(name)`` range,
so a profiler trace holds the program's spans on the kernels' timeline.  The
stamps share that timeline: the profiler's events lie at
``prof.profiler.kineto_results.trace_start_ns() + event.time_range.start *
1000``, which is ``CLOCK_REALTIME``, the clock of ``time.time_ns()``; the
start is stamped just before the range opens and the end just after it
closes, so the stamps bracket the range.

Spans on the per-step path record only while a profiler runs
(``torch.autograd.profiler._is_profiler_enabled``) or inside
``recording()``; otherwise ``span`` costs one flag check and hands back a
shared object that does nothing.  ``setup_span`` marks work done once a
process (building the model, the train state, the kernel library) and
always records.

A step id is given where a span knows its step (the loader's wait, the train
and eval steps, evaluate's read-back); a span without one takes its parent's,
or else the last one given on its thread.  Every name starts with ``fsar.``:
the names ``bn_chain`` and ``pb.*`` are the benchmark's own ranges.

The program's spans: ``fsar.loader.wait`` (data/episodes.py, the wait for a
batch), ``fsar.h2d`` (data/types.py ``Episode.to``), ``fsar.step``,
``fsar.augment``, ``fsar.forward``, ``fsar.backward``, ``fsar.optimizer``
(train/step.py), ``fsar.tower`` (the trunk or vision tower of every head:
models/heads/clipfsar.py, fsheads.py, molo.py), ``fsar.molo.motion`` (MoLo's
3-D conv, 3x3 conv and frame difference, attribute ``clips``) and
``fsar.molo.decode`` (its two decoder calls, attributes ``maps`` and
``pixels``, the maps' and the reconstructed pixels' count; models/heads/molo.py),
``fsar.ln`` / ``fsar.bn`` (models/clip/model.py), ``fsar.eval.fetch`` / ``fsar.eval.account``
(train/loop.py ``evaluate``), and the set-up spans ``fsar.setup.model``
(models/builder.py), ``fsar.setup.state`` (train/state.py,
train/optimizer.py) and ``fsar.setup.kernels`` (ops/_build.py).

Spans are kept in memory, from any thread: ``collect()`` returns them and,
per name, the calls, total and self nanoseconds (self: minus the time of the
spans nested in it); ``reset()`` clears them.  ``name_gaps`` names the card's
longest idle gaps by the innermost span open at each one's start.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _profiler

PREFIX = "fsar."
OUTSIDE = "other host work"  # name_gaps' name for a gap that no span covers

_lock = threading.Lock()
_spans: List["Span"] = []
_ids = itertools.count(1)
_recording = 0  # open recording() contexts
_local = threading.local()  # .stack: open spans of the thread; .step: its last step id


class Span(NamedTuple):
    """One recorded span; ``parent`` is the ``id`` of the span it was nested in."""

    name: str
    id: int
    parent: Optional[int]
    step: Optional[int]
    start_ns: int
    end_ns: int
    thread: int
    attrs: Dict[str, Any]

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def _thread_state():
    if not hasattr(_local, "stack"):
        _local.stack = []
        _local.step = None
    return _local


class _Open:
    """A span while it is open: enter, exit, and ``set`` for attributes known only inside."""

    __slots__ = ("name", "step", "attrs", "id", "parent", "start_ns", "_range")

    def __init__(self, name: str, step: Optional[int], attrs: Dict[str, Any]):
        if not name.startswith(PREFIX):
            raise ValueError(f"span {name!r}: the program's span names start with {PREFIX!r}")
        self.name, self.step, self.attrs = name, step, attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "_Open":
        local = _thread_state()
        parent = local.stack[-1] if local.stack else None
        self.parent = None if parent is None else parent.id
        if self.step is None:
            self.step = local.step if parent is None else parent.step
        else:
            local.step = self.step
        self.id = next(_ids)
        local.stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self.start_ns = time.time_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        end_ns = time.time_ns()
        _local.stack.pop()
        span = Span(self.name, self.id, self.parent, self.step, self.start_ns, end_ns, threading.get_ident(), self.attrs)
        with _lock:
            _spans.append(span)
        return False


class _Off:
    """What ``span`` hands back while nothing records."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, step: Optional[int] = None, **attrs):
    """A per-step span: records while a profiler runs or inside ``recording()``, else does nothing."""
    if not (_profiler._is_profiler_enabled or _recording):
        return _OFF
    return _Open(name, step, attrs)


def setup_span(name: str, **attrs) -> _Open:
    """A span of once-a-process set-up work: always records."""
    return _Open(name, None, attrs)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Per-step spans record inside this context, with no profiler running."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def reset() -> None:
    """Drop every recorded span."""
    with _lock:
        _spans.clear()


def collect() -> Dict[str, Any]:
    """``{"spans": [Span], "by_name": {name: {"calls", "total_ns", "self_ns"}}}`` of every span recorded since the last ``reset``."""
    with _lock:
        spans = list(_spans)
    nested: Dict[int, int] = {}
    for s in spans:
        if s.parent is not None:
            nested[s.parent] = nested.get(s.parent, 0) + s.ns
    by_name: Dict[str, Dict[str, int]] = {}
    for s in spans:
        row = by_name.setdefault(s.name, {"calls": 0, "total_ns": 0, "self_ns": 0})
        row["calls"] += 1
        row["total_ns"] += s.ns
        row["self_ns"] += s.ns - nested.get(s.id, 0)
    return {"spans": spans, "by_name": by_name}


def device_intervals(prof) -> List[Tuple[int, int]]:
    """The card's kernels and copies in a ``torch.profiler`` trace as (start, end) ns on the spans' clock; the
    ranges' own copies on the device timeline (user annotations) are left out."""
    base = prof.profiler.kineto_results.trace_start_ns()
    return [(base + round(e.time_range.start * 1000), base + round(e.time_range.end * 1000)) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def name_gaps(device_intervals_ns: Iterable[Tuple[int, int]], spans: Sequence[Span], top: int = 10) -> List[Tuple[str, int, int]]:
    """The ``top`` longest idle gaps between the card's busy intervals (ns on the spans' clock), longest first, as
    (name, start ns, length ns): each named by the innermost span open at its start (the one opened last), or
    ``OUTSIDE`` where none is."""
    merged: List[List[int]] = []
    for start, end in sorted(device_intervals_ns):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    gaps = sorted(((prev[1], nxt[0] - prev[1]) for prev, nxt in zip(merged, merged[1:])), key=lambda g: -g[1])[:top]
    out = []
    for at, length in gaps:
        inside = [s for s in spans if s.start_ns <= at < s.end_ns]
        out.append((max(inside, key=lambda s: s.start_ns).name if inside else OUTSIDE, at, length))
    return out
