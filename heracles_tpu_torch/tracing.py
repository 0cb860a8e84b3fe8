"""Spans and counters of heracles_tpu_torch.

Spans name the port's layers and the host work inside them.  With no
torch profiler recording, :func:`span` returns a shared no-op after one
flag check (and :func:`spanned` calls straight through); while one
records, a span is ``torch.profiler.record_function(name)``: a
``user_annotation`` event in the profiler's own trace, on the clock of
its device events, its parent the span that encloses it on the thread.
Nothing is kept here: run any call under ``torch.profiler.profile`` and
export its trace to see them.

Counters are always on, one ``collections.Counter`` increment an event,
in one registry: :func:`counter` gives the named counter (the same object
on every call), :func:`counts` a snapshot of all of them and
:func:`reset` zeroes all of them (every module's ``reset_counts`` calls
it).  Three counters say why the card waits on the host, each keyed by
the site that counts, named like a span:

* ``HOST_SYNCS[site]``: the host waits for the card (a copy to the host,
  a blocking copy to the card, a torch op that reads a device value on
  the host, a stream, event or device synchronisation);
* ``HOST_COPIES[site, "h2d" | "d2h"]``: copies between the host and the
  card, blocking or not, pageable or pinned;
* ``TABLE_BUILDS[table]``: arrays that depend only on the transform's
  sizes, spins, dtype and device, computed, read from a file or uploaded
  inside a call, and the one-off builds (the kernels' library, a pixel
  window computed, the ring weights read or solved).

The first two count only work on a CUDA card, so they read 0 on every
CPU path; table builds count on every device, as does

* ``TRANSFORM_STACKS[n]``: the calls of a mapper's ``transform`` that
  ``mapping.transform`` makes, keyed by the number of maps in the call
  (1 for a map alone).
"""

from __future__ import annotations

import collections
import functools

import torch
import torch.autograd.profiler as _profiler

__all__ = [
    "HOST_COPIES",
    "HOST_SYNCS",
    "TABLE_BUILDS",
    "TRANSFORM_STACKS",
    "built",
    "copied",
    "counter",
    "counts",
    "on_card",
    "reset",
    "span",
    "spanned",
    "synced",
    "to_host",
    "upload",
]

_COUNTERS = {}


def counter(name):
    """The registry's counter ``name``, made empty on first use."""
    c = _COUNTERS.get(name)
    if c is None:
        c = _COUNTERS[name] = collections.Counter()
    return c


def counts():
    """A snapshot of every counter: {name: {key: count}}."""
    return {name: dict(c) for name, c in _COUNTERS.items()}


def reset():
    """Zero every counter of the registry."""
    for c in _COUNTERS.values():
        c.clear()


HOST_SYNCS = counter("host_syncs")
HOST_COPIES = counter("host_copies")
TABLE_BUILDS = counter("table_builds")
TRANSFORM_STACKS = counter("transform_stacks")


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name):
    """A context manager: ``record_function(name)`` while a torch profiler
    records, else a no-op."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def spanned(name):
    """Decorator: every call of the function inside :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def on_card(where):
    """Whether ``where`` (a tensor, a device or its name) is a CUDA card."""
    if isinstance(where, torch.Tensor):
        return where.is_cuda
    return torch.device(where).type == "cuda"


def synced(site, where, n=1):
    """Count ``n`` host waits at ``site`` where ``where`` is on a card."""
    if on_card(where):
        HOST_SYNCS[site] += n


def copied(site, direction, where, n=1):
    """Count ``n`` host copies ("h2d" or "d2h") at ``site`` where
    ``where`` is on a card."""
    if on_card(where):
        HOST_COPIES[site, direction] += n


def built(table, n=1):
    """Count ``n`` builds of ``table``."""
    TABLE_BUILDS[table] += n


def upload(site, a, device, dtype=None):
    """``torch.as_tensor(a, dtype=dtype, device=device)``; from the host to
    a card a blocking copy, counted as a copy to the card and a wait at
    ``site``."""
    if on_card(device) and not (isinstance(a, torch.Tensor) and a.is_cuda):
        HOST_COPIES[site, "h2d"] += 1
        HOST_SYNCS[site] += 1
    return torch.as_tensor(a, dtype=dtype, device=device)


def to_host(site, t):
    """``t`` as a numpy array; from a card a blocking copy, counted as a
    copy to the host and a wait at ``site``."""
    if t.is_cuda:
        HOST_COPIES[site, "d2h"] += 1
        HOST_SYNCS[site] += 1
    return t.detach().cpu().numpy()
