"""The port's tracing: named spans on the profiler's timeline and byte
counters on the host-link copies.

- :func:`span` is ``torch.profiler.record_function(name)`` while a
  profiler runs, so the host's span sits on the same Kineto timeline as
  the device's kernels and copies: a reader charges each device op, and
  each idle gap, to the span the host was in.  With no profiler running it
  is one shared no-op context: one call and one check.
- :data:`SPANS` names every span the program opens.  A child's name
  begins with its parent's (``fold.finalize`` holds
  ``fold.finalize.download``); the ``copy.*`` spans sit inside whichever
  span made the copy.
- :func:`count` adds to :data:`COUNTS`, which the host-link copies of
  :mod:`repro_torch.kernels.agg_reduce` keep by kind
  (``copy.h2d_bytes.pageable``, ``copy.h2d_bytes.pinned``,
  ``copy.d2h_bytes.pageable``): bytes that crossed to or from a device
  other than the CPU, whether or not a profiler runs.  A reader takes the
  difference of :func:`counts` around what it measures.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

#: the span around a train step's clip, update and apply
UPDATE_SPAN = "train_step.update"

#: every span name the program opens
SPANS = (
    UPDATE_SPAN,
    # models/attention_impl.py: the eager path's scores, mask, softmax,
    # casts and value products, once a layer call
    "attention.core",
    # models/mlp.py: the router, top-k, gates, losses and masks; the
    # dispatch and combine einsums; the experts' FFN with its weights' casts
    "moe.route", "moe.dispatch", "moe.experts",
    # fl/messages.py, fl/flat.py: a fit result's decode, its header and
    # layout, a sparse delta's index check
    "fl.decode", "fl.decode.header", "fl.decode.check",
    # fl/agg_kernels.py, the torch backend's fold
    "fold.add", "fold.add.stage", "fold.add.scatter",
    "fold.finalize", "fold.finalize.close", "fold.finalize.cast",
    "fold.finalize.download", "fold.finalize.assemble",
    # kernels/agg_reduce.py: every copy over the host link
    "copy.h2d", "copy.d2h",
)

#: bytes by counter name; moved under ``_COUNTS_LOCK`` (folds of
#: concurrent jobs copy from several threads)
COUNTS: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` on a running profiler's timeline;
    the shared no-op when none runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name``."""
    with _COUNTS_LOCK:
        COUNTS[name] = COUNTS.get(name, 0) + int(n)


def counts() -> Dict[str, int]:
    """A copy of the counters."""
    with _COUNTS_LOCK:
        return dict(COUNTS)


def reset_counts() -> None:
    """Clear the counters."""
    with _COUNTS_LOCK:
        COUNTS.clear()
