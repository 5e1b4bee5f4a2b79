"""Worker subprocess lifecycle: spawn, framed pipe I/O, crash recovery.

Structure: :class:`_Pipe` owns the raw line-framed stdin/stdout pair of
one child process; :class:`WorkerProcess` layers policy on top — request
serialization, restart-with-backoff on broken pipes, liveness probing,
and graceful-then-forced shutdown. A crashed in-flight request is always
surfaced to the caller (never silently replayed: the worker may have
half-executed it).

Counterpart of ``rho_tts_tpu/isolation/procman.py``, with the same restart
budget, waits and recovery: a restarted worker is not sent ``INIT`` again,
so its first request after a crash is answered with an ``ERROR`` (as in the
reference package; change it only together with the reference).
"""

from __future__ import annotations

import logging
import subprocess
import threading
from typing import Optional

from .protocol import PING, PONG, SHUTDOWN, decode_message, encode_message

logger = logging.getLogger(__name__)

MAX_RESTARTS = 2
SHUTDOWN_GRACE_SEC = 10
KILL_WAIT_SEC = 5

WORKER_MODULE = "rho_tts_tpu_torch.isolation.worker"


class _Pipe:
    """Line-framed JSON I/O over one child's stdio."""

    def __init__(self, proc: subprocess.Popen):
        self.proc = proc

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def write(self, msg_type: str, **payload) -> None:
        self.proc.stdin.write(encode_message(msg_type, **payload))
        self.proc.stdin.flush()

    def read(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise BrokenPipeError("Worker closed stdout (crashed?)")
        return decode_message(line)

    def terminate(self) -> None:
        try:
            self.proc.kill()
            self.proc.wait(timeout=KILL_WAIT_SEC)
        except Exception:  # noqa: BLE001
            pass


def _spawn(python_path: str) -> _Pipe:
    cmd = [python_path, "-m", WORKER_MODULE]
    logger.debug("Starting worker: %s", " ".join(cmd))
    proc = subprocess.Popen(
        cmd,
        stdin=subprocess.PIPE,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        bufsize=1,  # line-buffered
    )
    threading.Thread(
        target=_relay_stderr, args=(proc,), daemon=True, name="worker-stderr"
    ).start()
    return _Pipe(proc)


def _relay_stderr(proc: subprocess.Popen) -> None:
    """Mirror the child's stderr into the parent logger ([worker] prefix)."""
    try:
        for line in iter(proc.stderr.readline, ""):
            line = line.rstrip("\n")
            if line:
                logger.info("[worker] %s", line)
    except Exception:  # noqa: BLE001
        pass


class WorkerProcess:
    """Policy wrapper over one long-running worker subprocess."""

    def __init__(self, python_path: str):
        self._python = python_path
        self._pipe: Optional[_Pipe] = None
        self._lock = threading.Lock()  # one outstanding request at a time
        self._restart_count = 0

    @property
    def alive(self) -> bool:
        return self._pipe is not None and self._pipe.alive

    def start(self) -> None:
        self._pipe = _spawn(self._python)

    # -- Request/response ------------------------------------------------------

    def send(self, msg_type: str, **payload) -> dict:
        """One request → one response, serialized and crash-recovered."""
        with self._lock:
            if not self.alive:
                raise RuntimeError("Worker is not running")
            try:
                self._pipe.write(msg_type, **payload)
                return self._pipe.read()
            except (BrokenPipeError, OSError, ValueError) as exc:
                self._recover_locked(exc)

    def _recover_locked(self, exc: Exception) -> None:
        """Restart after a pipe failure; the caller's request is lost."""
        if self._restart_count >= MAX_RESTARTS:
            raise RuntimeError(
                f"Worker crashed {self._restart_count + 1} times, giving up"
            ) from exc
        self._restart_count += 1
        logger.warning(
            "Worker communication failed (%s), restarting (%d/%d)...",
            exc,
            self._restart_count,
            MAX_RESTARTS,
        )
        if self._pipe is not None:
            self._pipe.terminate()
        self.start()
        raise RuntimeError(
            f"Worker crashed and was restarted. Original error: {exc}"
        ) from exc

    # -- Streaming / one-way -----------------------------------------------------

    def send_nowait(self, msg_type: str, **payload) -> None:
        """Fire-and-forget request (streaming replies read via receive())."""
        if not self.alive:
            raise RuntimeError("Worker is not running")
        self._pipe.write(msg_type, **payload)

    def receive(self) -> Optional[dict]:
        """One streamed response, or None at EOF / on malformed frames."""
        if not self.alive:
            return None
        try:
            return self._pipe.read()
        except Exception:  # noqa: BLE001
            return None

    def send_cancel(self) -> None:
        """Best-effort one-way CANCEL (raced against a blocking request)."""
        try:
            if self.alive:
                self._pipe.write("cancel")
        except (BrokenPipeError, OSError):
            logger.debug("Could not send cancel (worker already dead?)")

    def ping(self, timeout: float = 5.0) -> bool:
        """Liveness probe via PING/PONG."""
        try:
            return self.send(PING).get("type") == PONG
        except Exception:  # noqa: BLE001
            return False

    # -- Teardown ------------------------------------------------------------------

    def shutdown(self) -> None:
        """Ask the worker to exit; escalate to kill after the grace period."""
        with self._lock:
            if not self.alive:
                return
            try:
                self._pipe.write(SHUTDOWN)
                self._pipe.proc.wait(timeout=SHUTDOWN_GRACE_SEC)
                logger.debug("Worker shut down gracefully")
            except Exception:  # noqa: BLE001
                logger.warning("Graceful shutdown failed, killing worker")
                self._pipe.terminate()

    def kill(self) -> None:
        with self._lock:
            if self._pipe is not None:
                self._pipe.terminate()
                self._pipe = None
