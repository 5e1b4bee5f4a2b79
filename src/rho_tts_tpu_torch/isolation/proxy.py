"""ProviderProxy: duck-types the BaseTTS surface over an isolated worker.

Intentionally does NOT subclass BaseTTS and loads no model in the parent
process — the real engine, its kernels and its CUDA context live inside
the venv'd worker. Waveforms come back by file path; in-memory mode
round-trips through a temp directory that the proxy cleans up, and the
results hold the WAV's samples as a CPU float32 tensor (``load_wav``), so
``result.numpy()`` works as on every result of the port.

Counterpart of ``rho_tts_tpu/isolation/proxy.py``, with the same surface.
"""

from __future__ import annotations

import asyncio
import logging
import os
import shutil
import tempfile
import threading
from typing import Generator, List, Optional, Union

from . import protocol as P
from .procman import WorkerProcess
from .venvs import VenvManager

logger = logging.getLogger(__name__)

_CANCEL_POLL_INTERVAL = 0.1


def _load_tensor(path: str):
    """A worker's WAV as a 1-D CPU float32 tensor."""
    import torch

    from ..audio_io import load_wav

    audio, _sr = load_wav(path)
    return torch.from_numpy(audio)


class ProviderProxy:
    """Forwards TTS calls to a worker subprocess in an isolated venv."""

    def __init__(self, provider: str, **kwargs):
        from ..exceptions import ModelLoadError

        self._provider = provider
        self._kwargs = kwargs
        self._sample_rate: Optional[int] = None
        self._worker: Optional[WorkerProcess] = None
        self._shutting_down = False

        python_path = VenvManager(provider).ensure_venv()
        self._worker = WorkerProcess(python_path)
        self._worker.start()

        resp = self._worker.send(P.INIT, provider=provider, kwargs=kwargs)
        kind = resp.get("type")
        if kind == P.READY:
            self._sample_rate = resp["sample_rate"]
            logger.info(
                "Isolated provider '%s' ready (sample_rate=%d)", provider, self._sample_rate
            )
        else:
            self._hard_kill()
            if kind == P.ERROR:
                raise ModelLoadError(
                    f"Failed to initialize isolated provider '{provider}': "
                    f"{resp.get('message', 'unknown error')}"
                )
            raise ModelLoadError(f"Unexpected response from worker during init: {resp}")

    # -- BaseTTS-compatible surface ------------------------------------------

    @property
    def sample_rate(self) -> int:
        if self._sample_rate is None:
            raise RuntimeError("Provider not initialized")
        return self._sample_rate

    def generate(
        self,
        texts: Union[str, List[str]],
        output_path: Optional[str] = None,
        cancellation_token=None,
        format: str = "wav",
        speed: float = 1.0,
        pitch_semitones: float = 0.0,
        progress_callback=None,
    ):
        """Generate via the worker; single string or list of strings."""
        single_mode = isinstance(texts, str)

        cancel_stop = threading.Event()
        if cancellation_token is not None:
            self._spawn_cancel_forwarder(cancellation_token, cancel_stop)

        use_temp = output_path is None
        temp_dir = tempfile.mkdtemp(prefix="rho_tts_tpu_torch_proxy_") if use_temp else None
        effective = os.path.join(temp_dir, "output.wav") if use_temp else output_path

        try:
            payload = dict(
                format=format, speed=speed, pitch_semitones=pitch_semitones
            )
            if single_mode:
                resp = self._worker.send(
                    P.GENERATE, text=texts, output_path=effective, **payload
                )
            else:
                resp = self._worker.send(
                    P.GENERATE, texts=texts, output_base_path=effective, **payload
                )
        finally:
            cancel_stop.set()

        kind = resp.get("type")
        if kind == P.RESULT:
            return self._materialize(resp, single_mode, use_temp, temp_dir)
        self._rm_temp(temp_dir)
        if kind == P.CANCELLED:
            return None
        if kind == P.ERROR:
            raise RuntimeError(f"Worker error: {resp.get('message')}")
        raise RuntimeError(f"Unexpected response: {resp}")

    def _materialize(self, resp, single_mode, use_temp, temp_dir):
        """Rebuild GenerationResult(s) from a worker RESULT message."""
        from ..result import GenerationResult

        def load_audio(path):
            try:
                return _load_tensor(path)
            except Exception:  # noqa: BLE001
                return None

        if single_mode:
            if not resp.get("success", False):
                self._rm_temp(temp_dir)
                return None
            result = GenerationResult(
                sample_rate=self._sample_rate,
                duration_sec=resp.get("duration_sec", 0.0),
                segments_count=resp.get("segments_count", 0),
                format=resp.get("format", "wav"),
            )
            path = resp.get("output_path")
            if use_temp and path:
                result.audio = load_audio(path)
                self._rm_temp(temp_dir)
            else:
                result.path = path
            return result

        paths = resp.get("output_paths", [])
        durations = resp.get("durations", [])
        seg_counts = resp.get("seg_counts", [])
        results: List[Optional[GenerationResult]] = []
        for i, path in enumerate(paths):
            if path is None:
                results.append(None)
                continue
            r = GenerationResult(
                sample_rate=self._sample_rate,
                duration_sec=durations[i] if i < len(durations) else 0.0,
                segments_count=seg_counts[i] if i < len(seg_counts) else 0,
                format=resp.get("format", "wav"),
            )
            if use_temp:
                r.audio = load_audio(path)
            else:
                r.path = path
            results.append(r)
        self._rm_temp(temp_dir)
        return None if all(r is None for r in results) else results

    def stream(
        self,
        text: str,
        cancellation_token=None,
        speed: float = 1.0,
        pitch_semitones: float = 0.0,
    ) -> Generator:
        """Yield per-segment GenerationResults streamed from the worker."""
        from ..result import GenerationResult

        cancel_stop = threading.Event()
        if cancellation_token is not None:
            self._spawn_cancel_forwarder(cancellation_token, cancel_stop)

        temp_dir = tempfile.mkdtemp(prefix="rho_tts_tpu_torch_stream_")
        try:
            self._worker.send_nowait(
                P.STREAM,
                text=text,
                temp_dir=temp_dir,
                speed=speed,
                pitch_semitones=pitch_semitones,
            )
            while True:
                resp = self._worker.receive()
                if resp is None:
                    break
                kind = resp.get("type")
                if kind == P.SEGMENT_RESULT:
                    path = resp.get("path")
                    audio = None
                    try:
                        audio = _load_tensor(path)
                    except Exception:  # noqa: BLE001
                        pass
                    if audio is not None:
                        yield GenerationResult(
                            audio=audio,
                            sample_rate=self._sample_rate,
                            duration_sec=resp.get("duration_sec", 0.0),
                            segments_count=1,
                            format="wav",
                        )
                    if path and os.path.exists(path):
                        try:
                            os.remove(path)
                        except OSError:
                            pass
                elif kind in (P.RESULT, P.CANCELLED, P.ERROR):
                    break
        finally:
            cancel_stop.set()
            self._rm_temp(temp_dir)

    async def async_generate(
        self,
        texts: Union[str, List[str]],
        output_path: Optional[str] = None,
        cancellation_token=None,
        format: str = "wav",
        speed: float = 1.0,
        pitch_semitones: float = 0.0,
        progress_callback=None,
    ):
        """Async wrapper around generate()."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None,
            lambda: self.generate(
                texts,
                output_path=output_path,
                cancellation_token=cancellation_token,
                format=format,
                speed=speed,
                pitch_semitones=pitch_semitones,
            ),
        )

    def ping(self) -> bool:
        """Liveness probe of the worker."""
        return self._worker.ping() if self._worker else False

    # -- Lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
        return False

    def shutdown(self) -> None:
        """Idempotent graceful worker shutdown."""
        if self._shutting_down:
            return
        self._shutting_down = True
        if self._worker is not None:
            self._worker.shutdown()
            self._worker = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001
            pass

    # -- Internals ----------------------------------------------------------

    def _spawn_cancel_forwarder(self, token, stop_event: threading.Event) -> None:
        """Poll the token; forward a one-way CANCEL when it fires."""

        def poll():
            while not stop_event.is_set():
                if token.is_cancelled():
                    if self._worker is not None:
                        self._worker.send_cancel()
                    return
                stop_event.wait(_CANCEL_POLL_INTERVAL)

        threading.Thread(target=poll, daemon=True, name="cancel-forwarder").start()

    def _hard_kill(self) -> None:
        if self._worker is not None:
            self._worker.kill()
            self._worker = None

    @staticmethod
    def _rm_temp(temp_dir) -> None:
        if temp_dir:
            shutil.rmtree(temp_dir, ignore_errors=True)
