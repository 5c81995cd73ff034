"""Profiler spans in the serving path: ``span(name)`` opens the range
``repro_torch.<name>`` while a ``torch.profiler`` profile runs, and costs one
flag check otherwise.

A span is a host-side range (``RecordScope.FUNCTION``, as an operator's own
range is), not a user annotation: the profiler draws no device-side copy of
it, so a reading of the device timeline sees the card's operations alone.
Its events nest in the profile like any operator's, and every device
operation launched inside it points back to it through the profiler's launch
correlation and the launching operator's ``cpu_parent`` chain.

The spans of the serving path, each where its work happens:

* ``engine.admit`` (a step's admission), inside it ``engine.admit.chunk``
  (one prefill chunk's enqueue), ``engine.admit.pick`` (the admitted row's
  token and its read to the host), ``engine.admit.write`` (the staging cache
  copied into the slot);
* ``engine.decode`` (the decode part of a step, the interval
  ``ServeEngine.step_times`` measures), inside the batched decode
  ``engine.decode.prepare`` (the token grid, its block table and the copy to
  the device), ``engine.decode.forward`` (the enqueue of the whole step),
  ``engine.decode.sync`` (the step's one read to the host) and
  ``engine.decode.commit`` (each slot's token and retirement);
* ``moe.route``, ``moe.dispatch`` and ``moe.combine`` in each routed-expert
  layer.
"""
from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

PREFIX = "repro_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """The range ``repro_torch.<name>`` while a profiler runs, else a shared
    no-op context."""
    if _profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return _OFF
