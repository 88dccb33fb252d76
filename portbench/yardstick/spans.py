"""What the program's own spans say (`pigeon_tpu_torch.train.profiling`):
the spans it records while the harness's profiler traces a slice. The
first reader of a run takes every span out of the program's ring
(`profiling.drain`), so a run reads the spans recorded since the ring was
last emptied: those of its traced slice, and of each earlier attempt where
the harness profiles the slice again (`harness.TRACE_ATTEMPTS`). Each
reader returns None where the run holds no span of the name (a program
without spans, or a path that records none), never 0."""

from __future__ import annotations

import statistics

#: The run last read and the spans taken for it.
_taken: list = [None, []]


def recorded(run, name: str) -> list:
    """The program's spans of ``name`` for ``run``; none where the
    program records no spans."""
    if _taken[0] is not run:
        from pigeon_tpu_torch.train import profiling

        drain = getattr(profiling, "drain", None)
        _taken[:] = [run, [] if drain is None else drain()]
    return [s for s in _taken[1] if s.name == name]


def mean_ms(run, name: str):
    """The mean host milliseconds of the spans of ``name``."""
    values = [s.ms for s in recorded(run, name)]
    return statistics.fmean(values) if values else None


def mean_device_ms(run, name: str):
    """The mean milliseconds between the CUDA events of the spans of
    ``name`` that timed the card: its elapsed time, idle gaps included."""
    values = [v for v in (s.device_ms for s in recorded(run, name))
              if v is not None]
    return statistics.fmean(values) if values else None
