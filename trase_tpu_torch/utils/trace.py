"""Spans and counters of the port's host work, on the profiler's clock.

``span(name)`` marks a stretch of host work (the training loop's fetch,
the step's render, the compositor's backward ...) with a context manager.
Every span the port opens is named ``trase.<layer>[.<part>]``.

- Off (the default), a span is one shared no-op object: no allocation,
  no clock read. Where a ``torch.profiler`` is recording, it is
  ``torch.profiler.record_function(name)`` instead, so every profiler
  trace of the port (``train.py --profile_iters``, a benchmark's profiled
  stretch) carries the spans as ``user_annotation`` events beside the
  kernels they launch.
- On (``enable(True)``), a span appends a ``Span`` to an in-memory list,
  stamped with ``time.perf_counter_ns()``: its parent (the innermost
  span open on the same thread), its iteration (given, or the one the
  training loop set last with ``set_iteration``) and its thread; it
  enters ``record_function`` too where a profiler records, and only
  there: without one the annotation has no reader and only costs time
  (``record_function`` is an op called through ``torch.ops``).
  ``take()`` returns the list and clears it.

``counter(name)`` is a registry of plain host-side dicts of ints, counted
whether tracing is on or off (an increment is a dict store):
``layout_launches`` (every hand-written kernel's launches by
instantiation, ops/cuda_lib.py), ``cache`` (``("gt" | "masks",
"hit" | "miss")``, the training loop's device caches), ``mask_fetch``
(engine/loop.py), ``smooth_map`` (``("transpose",)``: the smoothing maps
transposed, the FEATURE steps' and each snapshot's; ``("max_in_degree",)``:
the largest in-degree among them, ops/knn.py) and ``nnfm``
(``(N1, N2, C)``: the NNFM's calls by the render's and the style's column
counts and the channels, losses/style.py).

No span or counter synchronises the device or reads a device tensor.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional

import torch

_profiling = torch.autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]  # the innermost span open on the same thread
    iteration: Optional[int]
    thread: str


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()

_on = False
_spans: list = []
_iteration: Optional[int] = None
_local = threading.local()
_counters: dict = {}


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Recorded:
    __slots__ = ("name", "iteration", "parent", "start", "annotation")

    def __init__(self, name: str, iteration: Optional[int]):
        self.name = name
        self.iteration = _iteration if iteration is None else iteration

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.annotation = (torch.profiler.record_function(self.name)
                           if _profiling() else NOOP)
        self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.annotation.__exit__(*exc)
        _stack().pop()
        _spans.append(Span(self.name, self.start, end, self.parent,
                           self.iteration, threading.current_thread().name))
        return False


def span(name: str, iteration: Optional[int] = None):
    """A context manager around the host work it encloses (module
    docstring); `iteration` overrides the loop's, for work done on
    another thread on behalf of an earlier iteration."""
    if _on:
        return _Recorded(name, iteration)
    if _profiling():
        return torch.profiler.record_function(name)
    return NOOP


def enable(on: bool = True):
    """Turn the recording of spans on or off."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def take() -> list:
    """The spans recorded so far, oldest end first; clears them."""
    global _spans
    out, _spans = _spans, []
    return out


def set_iteration(iteration: Optional[int]):
    """The iteration the spans opened from now on belong to."""
    global _iteration
    _iteration = iteration


def current_iteration() -> Optional[int]:
    return _iteration


def counter(name: str) -> dict:
    """The process's counter `name`: one dict of ints, the same object
    on every call."""
    return _counters.setdefault(name, {})


def bump(counts: dict, key, n: int = 1):
    """Add n to a counter's entry `key`."""
    counts[key] = counts.get(key, 0) + n


def summarize(spans) -> dict:
    """name -> {"count", "total_ms", "self_ms"} over `spans`; self time
    is a span's time less that of the spans opened inside it on its own
    thread (a parent is always of the child's thread)."""
    out: dict = {}
    for s in spans:
        ms = (s.end_ns - s.start_ns) * 1e-6
        d = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                    "self_ms": 0.0})
        d["count"] += 1
        d["total_ms"] += ms
        d["self_ms"] += ms
    for s in spans:
        if s.parent in out:
            out[s.parent]["self_ms"] -= (s.end_ns - s.start_ns) * 1e-6
    return out
