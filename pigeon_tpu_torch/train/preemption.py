"""Graceful-preemption handling for training loops.

The port's own copy of `pigeon_tpu/train/preemption.py`, with its
behaviour. Cloud machines are reclaimed with a SIGTERM and a grace
window (maintenance events, spot reclaims), and orchestrators (k8s,
slurm) stop jobs the same way. The reference has nothing here: its runs
die mid-epoch and its best-only weight saves cannot resume. Here a
signal sets a flag, the loop finishes the in-flight step, saves the
full TrainState synchronously, and returns, so ``--resume`` continues
exactly where the reclaim hit.

The guard is cooperative and cheap: the handler only flips a bool, and
loops poll ``guard.requested`` once per step (a Python attribute read —
nothing touches the device). Over several ranks a signal reaches one of
them: the loops (`train/loop.py`, `train/modes.py::pretrain`) then poll
`train.multihost.coordinated_flag` at shared step boundaries instead, so
every rank stops at the same step and takes the collective save. Signal handlers can only be installed in
the main thread; elsewhere (e.g. a worker running the loop under a
thread pool) the guard degrades to an inert flag rather than raising.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Iterable, Optional

logger = logging.getLogger("pigeon_tpu_torch.train")

#: Signals that mean "save and exit" by default. SIGTERM is what both
#: cloud preemptions and orchestrators (k8s, slurm) deliver first.
DEFAULT_SIGNALS = (signal.SIGTERM,)


class PreemptionGuard:
    """Context manager: turn SIGTERM into a cooperative stop request.

    Usage::

        with PreemptionGuard() as guard:
            for batch in batches:
                if guard.requested:
                    save_checkpoint(...)
                    break
                state, _ = train_step(state, batch)

    Prior handlers are restored on exit, so a guarded training phase
    inside a larger process (e.g. the CLI running train then eval)
    does not permanently swallow SIGTERM. ``request()`` lets tests and
    in-process supervisors trigger the same path without a real signal.
    """

    def __init__(self, signals: Iterable[int] = DEFAULT_SIGNALS):
        self._signals = tuple(signals)
        self._prior: dict = {}
        self._requested = threading.Event()
        self._installed = False

    # -- flag ------------------------------------------------------------
    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def request(self, signum: Optional[int] = None) -> None:
        """Flip the stop flag (what the signal handler does)."""
        if not self._requested.is_set():
            logger.warning(
                "preemption requested%s — will checkpoint and stop at the "
                "next step boundary",
                f" (signal {signum})" if signum is not None else "")
        self._requested.set()

    # -- installation ----------------------------------------------------
    def _handler(self, signum, _frame) -> None:
        self.request(signum)

    def __enter__(self) -> "PreemptionGuard":
        try:
            for sig in self._signals:
                self._prior[sig] = signal.signal(sig, self._handler)
            self._installed = True
        except ValueError:
            # Not the main thread: stay an inert flag (request() still
            # works for in-process supervisors/tests).
            self._prior.clear()
            logger.debug("PreemptionGuard: not in main thread — signal "
                         "handlers not installed")
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            for sig, prior in self._prior.items():
                signal.signal(sig, prior)
            self._prior.clear()
            self._installed = False
        return None
