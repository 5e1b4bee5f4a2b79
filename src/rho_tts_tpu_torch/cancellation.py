"""Cooperative cancellation primitive shared by host-side pipeline code.

The decode loop polls the token between decode chunks, and the engine
between pipeline segments and validation iterations; launches already
enqueued on the device run on. The token only needs to be cheap to poll and
safe to flip from any thread, so it is a plain flag under a lock. The port's
own copy of ``rho_tts_tpu.cancellation``.
"""

from __future__ import annotations

import threading

from .exceptions import RhoTTSError

__all__ = ["CancellationToken", "CancelledException"]


class CancelledException(RhoTTSError):
    """Raised from :meth:`CancellationToken.raise_if_cancelled` once a
    controller has cancelled the work."""


class CancellationToken:
    """Flag that lets one thread ask another to stop at its next checkpoint.

    The worker polls (``is_cancelled`` / ``raise_if_cancelled``) at points
    where stopping is safe; the controller flips the flag with ``cancel``.
    All methods may be called from any thread, any number of times.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cancelled = False

    def cancel(self) -> None:
        """Request cancellation (idempotent)."""
        with self._lock:
            self._cancelled = True

    def is_cancelled(self) -> bool:
        """True once :meth:`cancel` has been called (and not reset since)."""
        with self._lock:
            return self._cancelled

    def raise_if_cancelled(self, message: str | None = None) -> None:
        """Checkpoint: raise :class:`CancelledException` if cancelled."""
        if self.is_cancelled():
            raise CancelledException(message or "Task was cancelled")

    def reset(self) -> None:
        """Clear the flag so the token can be reused for a new task.

        A fresh token per task is usually clearer; the UI layer reuses
        session-scoped tokens, which is what this exists for.
        """
        with self._lock:
            self._cancelled = False
