"""Isolated worker entry point: ``<venv-python> -m rho_tts_tpu_torch.isolation.worker``.

Message loop over stdin/stdout (stdout carries protocol lines ONLY — all
logging goes to stderr). A reader thread owns stdin and routes CANCEL/PING
immediately while queueing blocking commands (GENERATE/STREAM/SHUTDOWN)
for the main thread, which owns the TTS instance and its GPU.

``INIT`` kwargs arrive as JSON, so a device is a string; the provider's
default device stays ``"cuda"``.

Counterpart of ``rho_tts_tpu/isolation/worker.py``, with the same frames.
"""

from __future__ import annotations

import logging
import os
import queue
import sys
import tempfile
import threading
from typing import Optional

from rho_tts_tpu_torch.cancellation import CancellationToken
from rho_tts_tpu_torch.factory import TTSFactory
from rho_tts_tpu_torch.isolation import protocol as P

logging.basicConfig(
    stream=sys.stderr,
    level=logging.INFO,
    format="%(levelname)s %(name)s: %(message)s",
)
logger = logging.getLogger("rho_tts_tpu_torch.worker")


class Worker:
    """Worker state + dispatch loop."""

    def __init__(self):
        self._tts = None
        self._cancel_token: Optional[CancellationToken] = None
        self._cancel_lock = threading.Lock()
        self._write_lock = threading.Lock()

    # -- Output -----------------------------------------------------------

    def _emit(self, msg_type: str, **payload) -> None:
        with self._write_lock:
            sys.stdout.write(P.encode_message(msg_type, **payload))
            sys.stdout.flush()

    def _new_token(self) -> CancellationToken:
        with self._cancel_lock:
            self._cancel_token = CancellationToken()
            return self._cancel_token

    def _clear_token(self) -> None:
        with self._cancel_lock:
            self._cancel_token = None

    # -- Handlers ----------------------------------------------------------

    def _handle_init(self, msg: dict) -> None:
        provider = msg.get("provider", "qwen")
        kwargs = msg.get("kwargs", {})
        logger.info("Initializing provider '%s'...", provider)
        try:
            self._tts = TTSFactory.get_tts_instance(provider=provider, **kwargs)
            self._emit(P.READY, sample_rate=self._tts.sample_rate)
            logger.info("Provider '%s' ready", provider)
        except Exception as exc:  # noqa: BLE001
            logger.error("Init failed: %s", exc)
            self._emit(P.ERROR, message=str(exc))

    def _handle_generate(self, msg: dict) -> None:
        texts = msg.get("texts") or msg.get("text")
        output_path = msg.get("output_base_path") or msg.get("output_path")
        token = self._new_token()
        try:
            result = self._tts.generate(
                texts,
                output_path,
                cancellation_token=token,
                format=msg.get("format", "wav"),
                speed=msg.get("speed", 1.0),
                pitch_semitones=msg.get("pitch_semitones", 0.0),
            )
            if token.is_cancelled():
                self._emit(P.CANCELLED)
            elif result is None:
                self._emit(P.RESULT, success=False)
            elif isinstance(result, list):
                self._emit(
                    P.RESULT,
                    output_paths=[r.path if r else None for r in result],
                    durations=[r.duration_sec if r else 0.0 for r in result],
                    seg_counts=[r.segments_count if r else 0 for r in result],
                    format=msg.get("format", "wav"),
                )
            else:
                self._emit(
                    P.RESULT,
                    output_path=result.path,
                    success=result.audio is not None,
                    duration_sec=result.duration_sec,
                    segments_count=result.segments_count,
                    format=result.format,
                )
        except Exception as exc:  # noqa: BLE001
            if token.is_cancelled():
                self._emit(P.CANCELLED)
            else:
                logger.error("generate failed: %s", exc)
                self._emit(P.ERROR, message=str(exc))
        finally:
            self._clear_token()

    def _handle_stream(self, msg: dict) -> None:
        text = msg.get("text", "")
        temp_dir = msg.get("temp_dir") or tempfile.gettempdir()
        token = self._new_token()
        try:
            seg_idx = 0
            for result in self._tts.stream(
                text,
                cancellation_token=token,
                speed=msg.get("speed", 1.0),
                pitch_semitones=msg.get("pitch_semitones", 0.0),
                # One SEGMENT_RESULT per TEXT segment (paths, not payloads):
                # chunk mode would write a WAV and a frame per decode chunk.
                chunked=False,
            ):
                if token.is_cancelled():
                    self._emit(P.CANCELLED)
                    return
                from rho_tts_tpu_torch.audio_io import save_wav

                seg_path = os.path.join(temp_dir, f"seg_{seg_idx}.wav")
                save_wav(seg_path, result.numpy(), result.sample_rate)
                self._emit(P.SEGMENT_RESULT, path=seg_path, duration_sec=result.duration_sec)
                seg_idx += 1
            self._emit(P.RESULT, success=True, segments=seg_idx)
        except Exception as exc:  # noqa: BLE001
            if token.is_cancelled():
                self._emit(P.CANCELLED)
            else:
                logger.error("stream failed: %s", exc)
                self._emit(P.ERROR, message=str(exc))
        finally:
            self._clear_token()

    # -- Main loop ----------------------------------------------------------

    def run(self) -> None:
        """Blocking loop: INIT handshake first, then the command queue."""
        line = sys.stdin.readline()
        if not line:
            return
        msg = P.decode_message(line)
        if msg.get("type") != P.INIT:
            self._emit(P.ERROR, message="Expected 'init' as first message")
            return
        self._handle_init(msg)
        if self._tts is None:
            return

        cmd_queue: "queue.Queue[Optional[dict]]" = queue.Queue()
        stop = threading.Event()

        def reader():
            while not stop.is_set():
                try:
                    raw = sys.stdin.readline()
                    if not raw:
                        cmd_queue.put(None)
                        return
                    incoming = P.decode_message(raw)
                except Exception:  # noqa: BLE001
                    cmd_queue.put(None)
                    return
                kind = incoming.get("type")
                if kind == P.CANCEL:
                    with self._cancel_lock:
                        if self._cancel_token is not None:
                            self._cancel_token.cancel()
                            logger.info("Cancellation requested")
                elif kind == P.PING:
                    self._emit(P.PONG)
                else:
                    cmd_queue.put(incoming)

        threading.Thread(target=reader, daemon=True, name="worker-reader").start()

        while True:
            msg = cmd_queue.get()
            if msg is None:
                break
            kind = msg.get("type")
            if kind == P.SHUTDOWN:
                logger.info("Shutdown received")
                break
            if kind == P.GENERATE:
                self._handle_generate(msg)
            elif kind == P.STREAM:
                self._handle_stream(msg)
            else:
                self._emit(P.ERROR, message=f"Unknown command: {kind}")

        stop.set()
        logger.info("Worker exiting")


def main():
    Worker().run()


if __name__ == "__main__":
    main()
