"""Named host spans at the port's layer boundaries, kept in memory.

    from repro_torch import spans

    spans.enable()
    ...                       # run_codesign, Model.prefill, ...
    recorded = spans.take()   # [Span(name, t0, t1), ...]
    spans.disable()

A span is opened with ``with spans.span(NAME):`` around one stage of a
layer, or with ``@spans.spanned(NAME)`` around every call of a function.
It records its name and its start and end on ``time.perf_counter``'s
clock.  A reader rebuilds the nesting from the times: a stage lies inside
the stage that called it, and the spans of one search or one prefill lie
inside its root (``codesign.search``, ``model.prefill``).  Any thread may
record; spans of two threads that run at once overlap without nesting.

Off is the default.  Then :func:`span` returns one shared context that
does nothing, so a stage costs a function call and an empty ``with``.
Names are module constants of the callers, never formatted strings.  The
module does no I/O and touches neither ``torch`` nor its profiler: a
reader ties ``perf_counter`` to whatever else it records.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import NamedTuple

__all__ = ["Span", "enable", "disable", "take", "span", "spanned"]


class Span(NamedTuple):
    name: str
    t0: float
    t1: float


class _Off:
    """The context every span is while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()
_on = False
_lock = threading.Lock()
_done: list[Span] = []


class _Open:
    """One span while it is open."""

    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Open":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        with _lock:
            _done.append(Span(self.name, self.t0, t1))
        return False


def enable() -> None:
    """Record the spans opened from now on."""
    global _on
    _on = True


def disable() -> None:
    """Open no more recording spans (those open now still record when they close)."""
    global _on
    _on = False


def take() -> list[Span]:
    """The spans closed since the last ``take``, in the order they closed; clears them."""
    global _done
    with _lock:
        out, _done = _done, []
    return out


def span(name: str):
    """A context manager around one stage: a recording span while on, else a shared no-op."""
    if not _on:
        return _OFF
    return _Open(name)


def spanned(name: str):
    """A decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
