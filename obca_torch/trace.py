"""Host spans and counters of the solver, the MPC loop and the warm
starts, for lining the host's work up with a device trace.

A *span* is a named stretch of host time; a *counter* a named running
count of host integers.  The recorder is process-wide and off by
default: then :func:`span` returns one shared no-op context manager and
:func:`count` returns at once.  When on (:func:`enable`), each span
records ``Span(name, start_ns, end_ns, parent, request)``: both times
from ``time.time_ns()`` (the clock ``torch.profiler``'s device events
are read on, so spans and a device trace line up without conversion),
``parent`` the index of the enclosing open span (-1 at the top) and
``request`` the caller's identifier (:func:`set_request`).  Records stay
in memory until :func:`take` returns and clears them.

No span or counter reads a tensor's value or synchronises with the
device: a span measures the host's time to issue work, and the only
waits it can hold are the syncs the program already makes.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int      # index of the enclosing span in the same take(); -1
    request: object  # the identifier set by set_request when it opened


_NULL = contextlib.nullcontext()
_on = False
_request = None
_spans: list = []    # [name, start_ns, end_ns, parent, request]
_open: list = []     # indices into _spans of the open spans
_counters: dict = {}


class _Open:
    __slots__ = ("rec",)

    def __init__(self, name):
        self.rec = [name, 0, 0, -1, None]

    def __enter__(self):
        rec = self.rec
        rec[3] = _open[-1] if _open else -1
        rec[4] = _request
        _open.append(len(_spans))
        _spans.append(rec)
        rec[1] = time.time_ns()

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        _open.pop()
        return False


def span(name: str):
    """A context manager recording ``name`` over its body when the
    recorder is on; the shared no-op one when it is off."""
    if not _on:
        return _NULL
    return _Open(name)


def count(name: str, n: int = 1) -> None:
    """Add the host integer ``n`` to counter ``name`` (recorder on)."""
    if not _on:
        return
    _counters[name] = _counters.get(name, 0) + n


def enable(on: bool = True) -> None:
    """Turn the recorder on (or off).  Records made so far stay."""
    global _on
    _on = bool(on)


def set_request(request) -> None:
    """The identifier every span opened from now on carries."""
    global _request
    _request = request


def take():
    """(spans, counters) recorded since the last take, cleared.  Take
    with no span open: an open span's index would not survive."""
    if _open:
        raise RuntimeError(f"trace.take with {len(_open)} span(s) open")
    spans = [Span(*r) for r in _spans]
    counters = dict(_counters)
    _spans.clear()
    _counters.clear()
    return spans, counters
