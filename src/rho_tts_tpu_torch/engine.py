"""BaseTTS: the generation engine / orchestrator (PyTorch port).

Counterpart of ``rho_tts_tpu/engine.py``: the same host-side state machine
around the model's device path. Providers subclass this and implement
``_generate_audio`` (+ ``sample_rate``); the engine owns text
preprocessing, segmentation, the validation retry loops, the DSP joining
on the waveform's device, saving, the async wrapper and the streaming API.

* Waveforms are tensors on the model's device through DSP and validation;
  validators receive in-memory (audio, sample_rate). The fused finalize
  fetches one (length, decay_ratio) pair per item, and
  :meth:`BaseTTS._finalize_items` one for a whole batch of items.
* Randomness is dual-tracked: Python/numpy seeds for host code plus a
  threefry key chain (``utils.prng``, bit for bit ``jax.random``'s), which
  providers consume via :meth:`BaseTTS.next_rng`.
* Cooperative cancellation is checked between text items, segments and
  validation iterations; providers additionally check between decode
  chunks.
* Smart segmentation reads the card's free memory
  (``torch.cuda.mem_get_info``), or the host's when on the CPU.
* Validation is the JAX package's: the accent-drift classifier
  (``validation.classifier``), the Whisper text match (``validation.stt``)
  and speaker similarity (``models.speaker``), with the same model lookup,
  thresholds and ``None`` → pass rules. A batch's drift features run as one
  pass on the waveforms' device, then its transcription; the text match is
  called after the drift gate, in line (the JAX package transcribes on a
  worker thread meanwhile, with the same results).
* The continuous-batching served path (``supports_serving_generation``):
  every segment is a request of the provider's ``ServingEngine``
  (``serving.py``), validated as it retires; a failed segment resubmits
  at once and rejoins the running slot batch. Its text match runs after
  the drift gate, in line, as in the batched path.

Public semantics parity with reference ``base_tts.py``: generate :960-1101,
_run_pipeline :708-956, stream :1132-1190, async_generate :1105-1128.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
import traceback
import uuid
from abc import ABC, abstractmethod
from typing import Callable, Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch

from . import audio_io, textproc
from .utils import prng, profiling
from .cancellation import CancellationToken, CancelledException
from .exceptions import FormatConversionError
from .ops import dsp
from .provider_info import ProviderInfo
from .result import GenerationResult

logger = logging.getLogger(__name__)

_SUPPORTED_FORMATS = audio_io.SUPPORTED_FORMATS

# Default phonetic mapping — users override via constructor.
DEFAULT_PHONETIC_MAPPING: Dict[str, str] = {}

# Error substrings that mark a retryable device-memory failure.
_OOM_MARKERS = ("out of memory", "resource exhausted", "length")


class BaseTTS(ABC):
    """Abstract base class for TTS providers."""

    MAX_MODEL_CHARS = 3000
    BYTES_PER_CHAR_ESTIMATE = 500_000

    #: Providers that accept a list in ``_generate_audio`` and benefit from
    #: batched device calls set this True: the pipeline then generates all
    #: of an item's segments in one batched model call and re-batches only
    #: the segments that fail validation — instead of the reference's
    #: one-segment-at-a-time loop (``base_tts.py:753-898``).
    supports_batch_generation = False

    #: Providers whose model can decode k independent samples of one text
    #: in a single batched call (e.g. Chatterbox's CFG batch of 2k rows)
    #: set this > 1 (instance attribute) and implement
    #: ``_generate_audio_candidates``: the sequential retry loop then
    #: generates k candidates per round and accepts the first that passes
    #: validation — at small batch the decode step is weight-read-bound,
    #: so k retry iterations cost roughly one (reference hot loop
    #: ``base_tts.py:770-898`` with chatterbox max_iterations=50).
    candidates_per_iteration = 1

    #: Providers backed by a continuous-batching serving engine set this
    #: True (instance attribute) and implement ``_serving_submit``: the
    #: pipeline then submits every segment as a serving request and
    #: validates segments as they retire (:meth:`_generate_segments_served`).
    supports_serving_generation = False

    def __init__(
        self,
        device: str = "cuda",
        seed: int = 789,
        deterministic: bool = False,
        phonetic_mapping: Optional[Dict[str, str]] = None,
    ):
        """
        Args:
            device: Device to run the model on ("cuda", "cuda:N" or "cpu").
            seed: Random seed for consistent voice generation.
            deterministic: If True, cuDNN runs deterministic algorithms and
                does not benchmark (the port's own kernels are
                bit-reproducible either way).
            phonetic_mapping: Custom word-to-pronunciation mapping, e.g.
                ``{"exocrine": "exo-crene"}``.
        """
        self.device = device
        self.seed = seed
        self.deterministic = deterministic
        if deterministic:
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self.phonetic_mapping = (
            phonetic_mapping if phonetic_mapping is not None else DEFAULT_PHONETIC_MAPPING.copy()
        )
        self._rng_key = None
        self._set_seeds()

        # Generation parameters (subclasses override as needed)
        self.max_chars_per_segment = 800
        self.max_iterations = 1

        # Validation thresholds (subclasses override as needed)
        self.accent_drift_threshold = 0.17
        self.text_similarity_threshold = 0.85
        self.sound_decay_threshold = 0.3
        self.max_decay_retries = 3

        # Audio segment smoothing parameters
        self.silence_threshold_db = -50.0
        self.crossfade_duration_sec = 0.05
        self.trim_silence = True
        self.fade_duration_sec = 0.02
        self.force_sentence_split = True
        self.inter_sentence_pause_sec = 0.1

        # Voice ID for per-voice classifier model lookup (set by UI state)
        self.voice_id: Optional[str] = None

        # Custom drift classifier model path (overrides voice_id lookup)
        self.drift_model_path: Optional[str] = None

        # Auto-sort: copy attempts to good/bad training folders after drift detection
        self.auto_sort_good_threshold: Optional[float] = None
        self.auto_sort_bad_threshold: Optional[float] = None
        self.auto_sort_good_dir: Optional[str] = None
        self.auto_sort_bad_dir: Optional[str] = None

        # Smart segmentation state
        self._max_chars_explicit = False
        self._max_model_chars = self.MAX_MODEL_CHARS

        # Speaker encoder for similarity validation (lazy loaded)
        self._speaker_encoder = None
        self.reference_embedding = None

    # -- Context manager protocol -------------------------------------------

    def close(self) -> None:
        """Release resources (model weights, device buffers)."""

    def _has_custom_decay_validator(self) -> bool:
        """True when a subclass/mocked _validate_sound_decay must get the
        final say (the fused finalize computes the stock ratio on device)."""
        return (
            "_validate_sound_decay" in self.__dict__
            or type(self)._validate_sound_decay is not BaseTTS._validate_sound_decay
        )

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
        return False

    # -- Provider introspection ---------------------------------------------

    @classmethod
    def provider_info(cls) -> ProviderInfo:
        """Return metadata about this provider. Override in subclasses."""
        return ProviderInfo(name=cls.__name__)

    # -- Randomness ----------------------------------------------------------

    def _set_seeds(self) -> None:
        """(Re)seed host RNGs and the threefry key chain from ``self.seed``."""
        random.seed(self.seed)
        np.random.seed(self.seed % (2**32))
        self._rng_key = prng.PRNGKey(self.seed)

    def next_rng(self) -> torch.Tensor:
        """Split and return a fresh threefry key ``(2,)`` on the CPU
        (deterministic per seed; ``jax.random.split``'s bits)."""
        if self._rng_key is None:
            self._rng_key = prng.PRNGKey(self.seed)
        keys = prng.split(self._rng_key, 2)
        self._rng_key, sub = keys[0], keys[1]
        return sub

    # -- Speaker encoder (lazy) ---------------------------------------------

    @property
    def speaker_encoder(self):
        """Lazy-load the speaker encoder for similarity validation, on the
        engine's device."""
        if self._speaker_encoder is None:
            from .models.speaker import SpeakerEncoder

            self._speaker_encoder = SpeakerEncoder(device=self.device)
        return self._speaker_encoder

    # -- Smart segmentation ---------------------------------------------------

    def _get_available_memory_bytes(self) -> int:
        """Free device memory when on a CUDA device, else available host RAM."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and torch.cuda.is_available():
            free, _total = torch.cuda.mem_get_info(dev)
            return int(free)
        try:
            import psutil

            return psutil.virtual_memory().available
        except ImportError:
            try:
                return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")
            except (ValueError, OSError):
                return 8 * 1024**3  # conservative default

    def _compute_max_chars(self) -> int:
        """Max chars per segment: min(model cap, 80% of free memory), floor 200."""
        if self._max_chars_explicit:
            return self.max_chars_per_segment

        model_max = self._max_model_chars
        bytes_per_char = self.BYTES_PER_CHAR_ESTIMATE

        available = self._get_available_memory_bytes()
        resource_max = int(available / bytes_per_char) if bytes_per_char > 0 else model_max

        effective = int(min(model_max, resource_max) * 0.8)
        return max(effective, 200)

    # -- Text preprocessing ---------------------------------------------------

    def _apply_phonetic_mapping(self, text: str) -> str:
        return textproc.apply_phonetic_mapping(text, self.phonetic_mapping)

    def _split_text_into_segments(self, text: str, max_chars: int) -> List[str]:
        return textproc.split_text_into_segments(
            text, max_chars, force_sentence_split=self.force_sentence_split
        )

    # -- Validation hooks -----------------------------------------------------

    def _validate_accent_drift(self, audio, sample_rate: int) -> tuple:
        """Accent-drift probability for in-memory audio; (prob, passed)."""
        if not getattr(self, "voice_cloning", False):
            return 0.0, True
        try:
            from .validation.classifier import predict_accent_drift_probability

            drift_prob = predict_accent_drift_probability(
                audio,
                sample_rate=sample_rate,
                voice_id=self.voice_id,
                model_path=self.drift_model_path,
                device=self.device,
            )
            if drift_prob is None:
                logger.warning(
                    "Accent drift analysis failed (feature extraction error), skipping validation"
                )
                return 0.0, True
            passed = drift_prob < self.accent_drift_threshold
            logger.info(
                f"Accent drift likelihood: {drift_prob:.2f} "
                f"(threshold: {self.accent_drift_threshold:.2f})"
            )
            return drift_prob, passed
        except ImportError:
            logger.debug("Accent drift classifier not available, skipping validation")
            return 0.0, True

    def _validate_accent_drift_batch(self, audios, sample_rate: int) -> list:
        """Batched accent-drift validation; list of (prob, passed).

        One bucketed feature pass on the device scores every segment (see
        ``validation.classifier.trainer.extract_features_batch_audio``);
        semantics per segment match :meth:`_validate_accent_drift`.
        """
        if not getattr(self, "voice_cloning", False):
            return [(0.0, True)] * len(audios)
        # Providers (and tests) may override the per-segment hook; the
        # batched fast path only applies to the stock implementation.
        bound = self._validate_accent_drift
        if getattr(bound, "__func__", None) is not BaseTTS._validate_accent_drift:
            return [bound(a, sample_rate) for a in audios]
        try:
            from .validation.classifier import predict_accent_drift_probability_batch

            probs = predict_accent_drift_probability_batch(
                audios,
                sample_rate,
                voice_id=self.voice_id,
                model_path=self.drift_model_path,
                device=self.device,
            )
        except ImportError:
            logger.debug("Accent drift classifier not available, skipping validation")
            return [(0.0, True)] * len(audios)
        out = []
        for prob in probs:
            if prob is None:
                out.append((0.0, True))
            else:
                out.append((prob, prob < self.accent_drift_threshold))
        return out

    def _auto_sort_audio(self, audio, drift_prob: float) -> None:
        """Save audio to the good/ or bad/ training folder based on drift score."""
        good_dir = getattr(self, "auto_sort_good_dir", None)
        bad_dir = getattr(self, "auto_sort_bad_dir", None)
        good_thresh = getattr(self, "auto_sort_good_threshold", None)
        bad_thresh = getattr(self, "auto_sort_bad_threshold", None)
        if good_dir is None and bad_dir is None:
            return
        name = f"rho_tts_validate_{uuid.uuid4().hex[:12]}.wav"
        try:
            if good_dir and good_thresh is not None and drift_prob < good_thresh:
                os.makedirs(good_dir, exist_ok=True)
                dest = os.path.join(good_dir, name)
                audio_io.save_wav(dest, audio, self.sample_rate)
                logger.info(f"      Auto-sorted to good: {dest}")
                return
            if bad_dir and bad_thresh is not None and drift_prob > bad_thresh:
                os.makedirs(bad_dir, exist_ok=True)
                dest = os.path.join(bad_dir, name)
                audio_io.save_wav(dest, audio, self.sample_rate)
                logger.info(f"      Auto-sorted to bad: {dest}")
                return
            # Middle zone: skip
        except OSError as e:
            logger.warning(f"      Auto-sort failed (non-fatal): {e}")

    def _validate_text_match(self, audio, sample_rate: int, expected_text: str) -> tuple:
        """STT text-match validation; (is_accurate, similarity, transcribed)."""
        try:
            from .validation.stt.stt_validator import validate_audio_text_match

            return validate_audio_text_match(
                (audio, sample_rate), expected_text, self.text_similarity_threshold,
                device=self.device,
            )
        except ImportError:
            logger.debug("STT validator not available, skipping text validation")
            return True, 1.0, None

    def _validate_text_match_batch(self, audios, sample_rate: int, texts) -> list:
        """Batched STT validation (one transcription pass per batch)."""
        try:
            from .validation.stt.stt_validator import validate_audio_text_match_batch

            return validate_audio_text_match_batch(
                [(a, sample_rate) for a in audios], texts, self.text_similarity_threshold,
                device=self.device,
            )
        except ImportError:
            logger.debug("STT validator not available, skipping text validation")
            return [(True, 1.0, None) for _ in audios]

    def _log_text_diff(self, expected: str, transcribed: str) -> None:
        """Log word-level differences between expected and transcribed text."""
        from difflib import SequenceMatcher

        exp_words = expected.lower().split()
        trans_words = transcribed.lower().split()
        sm = SequenceMatcher(None, exp_words, trans_words)

        missing, added, changed = [], [], []
        for op, i1, i2, j1, j2 in sm.get_opcodes():
            if op == "delete":
                missing.extend(exp_words[i1:i2])
            elif op == "insert":
                added.extend(trans_words[j1:j2])
            elif op == "replace":
                changed.append(
                    f"'{' '.join(exp_words[i1:i2])}' -> '{' '.join(trans_words[j1:j2])}'"
                )

        parts = []
        if missing:
            parts.append(f"missing: {' '.join(missing)}")
        if added:
            parts.append(f"extra: {' '.join(added)}")
        if changed:
            parts.append(f"changed: {', '.join(changed)}")

        if parts:
            logger.warning(f"      Text diff: {'; '.join(parts)}")
        else:
            logger.warning("      Text diff: difference is in punctuation/formatting only")
            logger.warning(f"      Expected: {expected[:80]}")
            logger.warning(f"      Got:      {transcribed[:80]}")

    def _validate_sound_decay(self, audio) -> tuple:
        """(ratio, is_ok) where ratio = last-third RMS / first-third RMS."""
        if int(np.prod(audio.shape)) == 0:
            return 1.0, True
        ratio = dsp.sound_decay_ratio(audio)
        threshold = getattr(self, "sound_decay_threshold", 0.3)
        return ratio, ratio >= threshold

    def _compute_speaker_similarity(self, audio) -> float:
        """Cosine similarity between generated audio and the reference voice."""
        generated_embedding = np.asarray(
            self.speaker_encoder.embed_utterance(audio, self.sample_rate)
        )
        reference = np.asarray(self.reference_embedding)
        return float(
            np.dot(reference, generated_embedding)
            / (np.linalg.norm(reference) * np.linalg.norm(generated_embedding))
        )

    # -- DSP (delegates to ops.dsp) -------------------------------------------

    def _trim_silence(self, audio, from_start: bool = True, from_end: bool = True):
        return dsp.trim_silence(
            audio,
            self.sample_rate,
            threshold_db=self.silence_threshold_db,
            from_start=from_start,
            from_end=from_end,
            enabled=self.trim_silence,
        )

    def _remove_dc_offset(self, audio):
        return dsp.remove_dc_offset(audio)

    def _apply_fades(self, audio, fade_in: bool = True, fade_out: bool = True):
        return dsp.apply_fades(
            audio,
            self.sample_rate,
            fade_duration_sec=self.fade_duration_sec,
            fade_in=fade_in,
            fade_out=fade_out,
        )

    def _fused_finalize_mode(self):
        """Whether the finalize chain can run fused (one host fetch).

        "plain" when the provider keeps the default (no-op) post-processing,
        "loudness" when it declares its post-processing IS the standard
        loudness chain (``post_process_is_loudness``), else None → generic
        multi-dispatch path.
        """
        overridden = type(self)._post_process_audio is not BaseTTS._post_process_audio
        if not overridden:
            return "plain"
        if getattr(self, "post_process_is_loudness", False):
            return "loudness"
        return None

    def _smooth_segment_join(self, audio_segments: List):
        return dsp.smooth_segment_join(
            audio_segments,
            self.sample_rate,
            crossfade_duration_sec=self.crossfade_duration_sec,
            inter_sentence_pause_sec=self.inter_sentence_pause_sec,
            trim=self.trim_silence,
            silence_threshold_db=self.silence_threshold_db,
            fade_duration_sec=self.fade_duration_sec,
        )

    # -- Abstract provider surface --------------------------------------------

    @abstractmethod
    def _generate_audio(self, text: Union[str, List[str]], **kwargs):
        """Synthesize raw audio for a text (or list of texts).

        Returns a 1-D float32 waveform array (or list thereof).
        """

    def _post_process_audio(self, audio):
        """Provider-specific post-processing before validation (no-op here)."""
        return audio

    def _free_device_memory(self) -> None:
        """Best-effort release of dead device buffers after an OOM: a
        collection, then the caching allocator's unused blocks go back."""
        import gc

        gc.collect()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    # -- Speed / pitch post-processing ----------------------------------------

    def _apply_speed_pitch(self, audio, speed: float, pitch_semitones: float):
        """Apply playback-speed and pitch-shift adjustments on device.

        Parity: reference ``base_tts.py:618-650`` (resample for speed, phase
        vocoder pitch shift); both run on the waveform's device.
        """
        from .ops import pitch as pitch_ops
        from .ops import resample as resample_ops

        if speed != 1.0:
            audio = resample_ops.resample(
                audio, int(self.sample_rate * speed), self.sample_rate
            )
        if pitch_semitones != 0.0:
            audio = pitch_ops.pitch_shift(audio, self.sample_rate, pitch_semitones)
        return audio

    # -- Save helpers ----------------------------------------------------------

    def _save_wav(self, path: str, audio, sample_rate: int) -> None:
        audio_io.save_wav(path, audio, sample_rate)

    @staticmethod
    def _convert_format(wav_path: str, target_format: str) -> str:
        return audio_io.convert_format(wav_path, target_format)

    # -- Batched segment generation -------------------------------------------

    def _generate_segments_batched(
        self,
        segments: List[str],
        token: CancellationToken,
        progress_callback: Optional[Callable[[str], None]] = None,
    ):
        """Generate + validate all segments with batched model calls.

        Returns (audios, drift_scores, text_sims) where ``audios[i]`` is
        None for segments that never produced audio. Validation gates and
        fallback semantics (best-by-drift, then last audio) match the
        sequential path; only the batching strategy differs: iteration 0
        synthesizes every segment in one device call, later iterations
        re-batch only the failures with fresh seeds.
        """
        n = len(segments)
        best: List = [None] * n
        final: List[bool] = [False] * n
        best_drift = [float("inf")] * n
        best_sim: List[Optional[float]] = [None] * n
        last: List = [None] * n

        batch_cap = max(int(getattr(self, "batch_size", 0) or n), 1)
        pending = list(range(n))
        self._set_seeds()

        for iteration in range(self.max_iterations):
            if token.is_cancelled():
                raise CancelledException("Cancelled during batched generation")
            if iteration > 0:
                self.seed = int(time.time() * 1000) % 100000
                self._set_seeds()

            if progress_callback:
                progress_callback(
                    f"Generating {len(pending)} segment(s) (iteration {iteration + 1})..."
                )
            logger.info(
                f"    Batched iteration {iteration + 1}: {len(pending)} segment(s), "
                f"seed {self.seed}"
            )

            outs: Dict[int, object] = {}
            for start in range(0, len(pending), batch_cap):
                chunk_idx = pending[start : start + batch_cap]
                try:
                    res = self._generate_audio([segments[i] for i in chunk_idx])
                except (ValueError, NotImplementedError):
                    raise  # config error — don't retry
                except RuntimeError as e:
                    msg = str(e).lower()
                    if any(m in msg for m in _OOM_MARKERS):
                        logger.error(f"    Batch OOM: {e}")
                        self._free_device_memory()
                        continue
                    raise
                except Exception as e:  # noqa: BLE001
                    logger.warning(f"    Batch generation error ({e})")
                    continue
                for i, audio in zip(chunk_idx, res):
                    outs[i] = audio
                    last[i] = audio

            if self.max_iterations == 1:
                for i in pending:
                    if i in outs:
                        best[i] = outs[i]
                        final[i] = True
                        if getattr(self, "auto_sort_good_dir", None) or getattr(
                            self, "auto_sort_bad_dir", None
                        ):
                            try:
                                drift_prob, _ = self._validate_accent_drift(
                                    outs[i], self.sample_rate
                                )
                                self._auto_sort_audio(outs[i], drift_prob)
                            except Exception as e:  # noqa: BLE001
                                logger.warning(f"    Auto-sort drift check failed ({e})")
                break

            still_pending = [i for i in pending if i not in outs]
            gen_idx = [i for i in pending if i in outs]

            # Phase 1: accent drift for every generated segment, as one batch.
            drift_results = None
            if gen_idx:
                try:
                    with profiling.stage("validate/drift"):
                        drift_results = self._validate_accent_drift_batch(
                            [outs[i] for i in gen_idx], self.sample_rate
                        )
                except Exception as e:  # noqa: BLE001
                    logger.warning(f"    Batched drift validation error ({e})")

            voice_ok_idx: List[int] = []
            drifts: Dict[int, float] = {}
            for pos, i in enumerate(gen_idx):
                audio = outs[i]
                try:
                    if drift_results is not None:
                        drift_prob, is_voice_ok = drift_results[pos]
                    else:
                        drift_prob, is_voice_ok = self._validate_accent_drift(
                            audio, self.sample_rate
                        )
                    self._auto_sort_audio(audio, drift_prob)
                    drifts[i] = drift_prob
                    if drift_prob < best_drift[i]:
                        best_drift[i] = drift_prob
                        best[i] = audio
                    if is_voice_ok:
                        voice_ok_idx.append(i)
                    else:
                        logger.warning(
                            f"    Segment {i + 1} invalid: drift={drift_prob:.3f}"
                        )
                        still_pending.append(i)
                except Exception as e:  # noqa: BLE001
                    logger.warning(f"    Segment {i + 1}: validation error ({e})")
                    still_pending.append(i)

            # Phase 2: text match for the drift-passing segments, as one
            # batch. The JAX package transcribes every generated segment on
            # a worker thread while drift runs and keeps the drift-passing
            # ones' results; the port transcribes those segments after the
            # drift gate, in line (whether the overlap pays is measured by
            # chip_smoke.py's phase 8: drift and STT times apart).
            if voice_ok_idx:
                try:
                    with profiling.stage("validate/stt"):
                        stt_results = self._validate_text_match_batch(
                            [outs[i] for i in voice_ok_idx], self.sample_rate,
                            [segments[i] for i in voice_ok_idx],
                        )
                except Exception as e:  # noqa: BLE001
                    logger.warning(f"    Batched STT validation error ({e})")
                    stt_results = [(True, 1.0, None)] * len(voice_ok_idx)

                for i, (is_text_ok, text_sim, transcribed) in zip(
                    voice_ok_idx, stt_results
                ):
                    best_sim[i] = text_sim
                    if is_text_ok:
                        best[i] = outs[i]
                        final[i] = True
                    else:
                        if transcribed:
                            try:
                                self._log_text_diff(segments[i], transcribed)
                            except Exception:  # noqa: BLE001
                                pass
                        logger.warning(
                            f"    Segment {i + 1} invalid: text={text_sim:.3f}"
                        )
                        still_pending.append(i)

            pending = still_pending
            if not pending:
                break

        # Exhausted retries: fall back to best-by-drift, else last audio
        for i in range(n):
            if final[i] or best[i] is not None:
                continue
            if last[i] is not None:
                best[i] = last[i]
                logger.warning(
                    f"    Segment {i + 1}: max iterations reached, returning last audio"
                )

        return best, best_drift, best_sim

    # -- Serving-backed segment generation --------------------------------------

    def _serving_submit(self, text: str):
        """Submit one segment to the provider's continuous-batching serving
        engine; returns a :class:`rho_tts_tpu_torch.serving.ServeRequest`-like
        future (``add_done_callback`` / ``wav`` / ``error`` / ``cancel``).
        Providers that set ``supports_serving_generation`` implement this."""
        raise NotImplementedError

    def _generate_segments_served(
        self,
        segments: List[str],
        token: CancellationToken,
        progress_callback: Optional[Callable[[str], None]] = None,
    ):
        """Generate + validate segments through the serving engine.

        The contract and gate semantics of :meth:`_generate_segments_batched`
        (drift gate with best-by-drift tracking, auto-sort, max_iterations
        cap, best/last fallback), without an iteration barrier: every segment
        is a serving request, validated as it retires; a failed segment
        resubmits at once and joins the in-flight slot batch. Retries draw
        fresh per-request seeds from the serving engine.
        """
        import queue as _q

        n = len(segments)
        best: List = [None] * n
        final: List[bool] = [False] * n
        best_drift = [float("inf")] * n
        best_sim: List[Optional[float]] = [None] * n
        last: List = [None] * n
        tries = [0] * n

        self._set_seeds()
        done_q: "_q.Queue[int]" = _q.Queue()
        inflight: Dict[int, object] = {}

        def submit(i: int) -> None:
            tries[i] += 1
            req = self._serving_submit(segments[i])
            inflight[i] = req
            req.add_done_callback(lambda _r, i=i: done_q.put(i))

        def cancel_inflight() -> None:
            for req in inflight.values():
                try:
                    req.cancel()
                except Exception:  # noqa: BLE001
                    pass

        if progress_callback:
            progress_callback(f"Generating {n} segment(s) (serving)...")
        try:
            self._served_loop(
                segments, token, progress_callback, done_q, inflight, submit,
                best, final, best_drift, best_sim, last, tries,
            )
        except BaseException:
            cancel_inflight()
            raise

        # Segments that never produced audio keep best=None; segments that
        # exhausted retries already carry best-by-drift (else last audio).
        for i in range(n):
            if final[i] or best[i] is not None:
                continue
            if last[i] is not None:
                best[i] = last[i]
        return best, best_drift, best_sim

    def _served_loop(
        self, segments, token, progress_callback, done_q, inflight, submit,
        best, final, best_drift, best_sim, last, tries,
    ):
        """Completion-driven retry loop of :meth:`_generate_segments_served`."""
        import queue as _q

        n = len(segments)
        for i in range(n):
            submit(i)

        validate = self.max_iterations > 1
        auto_sort = bool(
            getattr(self, "auto_sort_good_dir", None)
            or getattr(self, "auto_sort_bad_dir", None)
        )

        while inflight:
            if token.is_cancelled():
                raise CancelledException("Cancelled during served generation")
            try:
                ready = [done_q.get(timeout=0.2)]
            except _q.Empty:
                continue
            # Coalesce the rest of this retire burst into one validation
            # batch (retirements arrive grouped at chunk boundaries).
            deadline = time.time() + 0.01
            while True:
                try:
                    ready.append(done_q.get(timeout=max(deadline - time.time(), 0)))
                except _q.Empty:
                    break
            if token.is_cancelled():
                raise CancelledException("Cancelled during served generation")

            group: List[int] = []  # segments with fresh audio to validate
            for i in ready:
                req = inflight.pop(i)
                err = getattr(req, "error", None)
                if err is not None:
                    if isinstance(err, ValueError):
                        raise err  # config error — don't retry
                    logger.warning(f"    Segment {i + 1}: generation error ({err})")
                    if tries[i] < self.max_iterations:
                        submit(i)
                    continue
                audio = req.wav
                if audio is None or getattr(req, "cancelled", False):
                    logger.warning(f"    Segment {i + 1}: no audio from serving")
                    if tries[i] < self.max_iterations:
                        submit(i)
                    continue
                last[i] = audio
                if not validate:
                    best[i] = audio
                    final[i] = True
                    if auto_sort:
                        try:
                            drift_prob, _ = self._validate_accent_drift(audio, self.sample_rate)
                            self._auto_sort_audio(audio, drift_prob)
                        except Exception as e:  # noqa: BLE001
                            logger.warning(f"    Auto-sort drift check failed ({e})")
                    continue
                group.append(i)
            if not group:
                continue

            if progress_callback:
                done_ct = sum(final) + sum(
                    1 for i in range(n) if best[i] is not None and not final[i]
                )
                progress_callback(
                    f"Validating {len(group)} segment(s) ({done_ct}/{n} settled)..."
                )

            drift_results = None
            try:
                with profiling.stage("validate/drift"):
                    drift_results = self._validate_accent_drift_batch(
                        [last[i] for i in group], self.sample_rate
                    )
            except Exception as e:  # noqa: BLE001
                logger.warning(f"    Batched drift validation error ({e})")

            voice_ok_idx: List[int] = []
            failed: List[int] = []
            for pos, i in enumerate(group):
                audio = last[i]
                try:
                    if drift_results is not None:
                        drift_prob, is_voice_ok = drift_results[pos]
                    else:
                        drift_prob, is_voice_ok = self._validate_accent_drift(
                            audio, self.sample_rate
                        )
                    self._auto_sort_audio(audio, drift_prob)
                    if drift_prob < best_drift[i]:
                        best_drift[i] = drift_prob
                        best[i] = audio
                    if is_voice_ok:
                        voice_ok_idx.append(i)
                    else:
                        logger.warning(f"    Segment {i + 1} invalid: drift={drift_prob:.3f}")
                        failed.append(i)
                except Exception as e:  # noqa: BLE001
                    logger.warning(f"    Segment {i + 1}: validation error ({e})")
                    failed.append(i)

            # The text match of the drift-passing segments, as one batch, in
            # line (the JAX package transcribes the whole group on a worker
            # thread meanwhile and keeps these segments' results).
            if voice_ok_idx:
                try:
                    with profiling.stage("validate/stt"):
                        stt_results = self._validate_text_match_batch(
                            [last[i] for i in voice_ok_idx], self.sample_rate,
                            [segments[i] for i in voice_ok_idx],
                        )
                except Exception as e:  # noqa: BLE001
                    logger.warning(f"    Batched STT validation error ({e})")
                    stt_results = [(True, 1.0, None)] * len(voice_ok_idx)
                for i, (is_text_ok, text_sim, transcribed) in zip(voice_ok_idx, stt_results):
                    best_sim[i] = text_sim
                    if is_text_ok:
                        best[i] = last[i]
                        final[i] = True
                    else:
                        if transcribed:
                            try:
                                self._log_text_diff(segments[i], transcribed)
                            except Exception:  # noqa: BLE001
                                pass
                        logger.warning(f"    Segment {i + 1} invalid: text={text_sim:.3f}")
                        failed.append(i)

            for i in failed:
                if tries[i] < self.max_iterations:
                    submit(i)
                else:
                    logger.warning(
                        f"    Segment {i + 1}: max iterations reached, "
                        f"returning best available audio"
                    )

    # -- Candidate-batched retry loop -------------------------------------------

    def _generate_audio_candidates(self, text: str, k: int) -> List:
        """Generate ``k`` independent samples of one segment in a single
        batched model call. Providers that set ``candidates_per_iteration``
        > 1 implement this (e.g. Chatterbox's 2k-row CFG batch)."""
        raise NotImplementedError

    def _retry_segment_candidates(
        self, segment: str, token: CancellationToken, seg_idx: int
    ):
        """Validation retry loop, k candidates per round.

        Gate semantics match the one-generation-per-iteration loop
        (reference ``base_tts.py:770-898``): drift gate with best-by-drift
        tracking, STT gate, auto-sort per attempt, best/last-audio
        fallback. Each round consumes ``k`` of ``max_iterations`` —
        ``max_iterations`` still bounds total sampled attempts — but the
        k attempts share one decode batch and ONE batched drift / STT
        program, so a round costs about one iteration's wall. Candidates
        are ordered (row 0 first); the first passing both gates wins,
        keeping acceptance independent of validation batching.

        Returns (best_audio, best_drift, best_text_sim).
        """
        best_audio = None
        best_drift = float("inf")
        best_text_sim = None
        last_audio = None

        attempts = 0
        round_no = 0
        cur_k = self.candidates_per_iteration
        while attempts < self.max_iterations:
            if token.is_cancelled():
                raise CancelledException(
                    f"Cancelled during candidate round {round_no + 1} of "
                    f"segment {seg_idx + 1}"
                )
            if round_no > 0:
                self.seed = int(time.time() * 1000) % 100000
                self._set_seeds()
            round_no += 1
            k = min(cur_k, self.max_iterations - attempts)
            logger.info(
                f"    Candidate round {round_no}: {k} sample(s), seed {self.seed} "
                f"({attempts}/{self.max_iterations} attempts consumed)"
            )

            try:
                with profiling.stage("generate/candidates"):
                    cands = self._generate_audio_candidates(segment, k)
            except (ValueError, NotImplementedError):
                raise  # config error — don't retry
            except RuntimeError as e:
                msg = str(e).lower()
                if any(m in msg for m in _OOM_MARKERS):
                    # Charge ONE iteration (the reference charges OOM retries)
                    # and shrink the candidate batch: a 2k-row CFG batch that
                    # reproducibly doesn't fit must not fail every round.
                    logger.error(f"    Segment {seg_idx + 1} OOM at k={k}: {e}")
                    attempts += 1
                    cur_k = max(1, k // 2)
                    self._free_device_memory()
                    continue
                raise
            except Exception as e:  # noqa: BLE001
                logger.warning(f"    Segment {seg_idx + 1}: generation error ({e})")
                attempts += 1
                continue
            attempts += k
            if not cands:
                continue
            last_audio = cands[-1]

            try:
                with profiling.stage("validate/drift"):
                    drift_results = self._validate_accent_drift_batch(
                        cands, self.sample_rate
                    )
            except Exception as e:  # noqa: BLE001
                # Same fallback as the lockstep batched path: keep the
                # candidates and validate each one individually.
                logger.warning(f"    Batched drift validation error ({e})")
                drift_results = None

            passing: List[int] = []
            for pos in range(len(cands)):
                try:
                    if drift_results is not None:
                        drift_prob, is_voice_ok = drift_results[pos]
                    else:
                        drift_prob, is_voice_ok = self._validate_accent_drift(
                            cands[pos], self.sample_rate
                        )
                    self._auto_sort_audio(cands[pos], drift_prob)
                except Exception as e:  # noqa: BLE001
                    logger.warning(
                        f"    Segment {seg_idx + 1} candidate {pos + 1}: "
                        f"validation error ({e})"
                    )
                    continue
                if drift_prob < best_drift:
                    best_drift = drift_prob
                    best_audio = cands[pos]
                if is_voice_ok:
                    passing.append(pos)
            if not passing:
                logger.warning(
                    f"    Segment {seg_idx + 1}: no candidate passed drift "
                    f"(best {best_drift:.3f}), retrying"
                )
                continue

            try:
                with profiling.stage("validate/stt"):
                    stt_results = self._validate_text_match_batch(
                        [cands[i] for i in passing],
                        self.sample_rate,
                        [segment] * len(passing),
                    )
            except Exception as e:  # noqa: BLE001
                # The sequential loop this path replaces treats a validation
                # exception as a failed attempt (retry) — match it rather
                # than accepting candidates with a fabricated similarity.
                logger.warning(
                    f"    Batched STT validation error ({e}); retrying round"
                )
                continue

            for pos, (is_text_ok, text_sim, transcribed) in zip(passing, stt_results):
                best_text_sim = text_sim
                if is_text_ok:
                    logger.info(
                        f"    Segment {seg_idx + 1} valid: candidate {pos + 1} of "
                        f"round {round_no} ({attempts} attempt(s) consumed)"
                    )
                    return cands[pos], best_drift, text_sim
                if transcribed:
                    try:
                        self._log_text_diff(segment, transcribed)
                    except Exception:  # noqa: BLE001
                        pass
            logger.warning(
                f"    Segment {seg_idx + 1}: no candidate passed STT, retrying"
            )

        if best_audio is not None:
            logger.warning(
                f"    Segment {seg_idx + 1}: max iterations reached, "
                f"returning best (drift={best_drift:.3f})"
            )
        elif last_audio is not None:
            best_audio = last_audio
            logger.warning(
                f"    Segment {seg_idx + 1}: max iterations reached, "
                f"returning last audio"
            )
        return best_audio, best_drift, best_text_sim

    # -- Item finalization (join + post-process + decay check) -----------------

    def _finalize_items(self, items: List[List]):
        """Finalize several items' segment lists with ONE packed meta fetch.

        Enqueues every item's fused finalize on the device, then pulls all
        (length, decay_ratio) pairs in a single host transfer: each fetch
        waits for the device to drain. Falls back to the per-item path when
        the fused mode is unavailable.
        """
        fused_mode = self._fused_finalize_mode()
        if fused_mode is None or len(items) <= 1:
            return [self._finalize_item(segs) for segs in items]

        custom_decay = self._has_custom_decay_validator()
        with profiling.stage("dsp/finalize_fused"):
            staged = []
            for segs in items:
                staged.append(
                    dsp.finalize_segments(
                        segs,
                        self.sample_rate,
                        crossfade_duration_sec=self.crossfade_duration_sec,
                        inter_sentence_pause_sec=self.inter_sentence_pause_sec,
                        trim=self.trim_silence,
                        silence_threshold_db=self.silence_threshold_db,
                        fade_duration_sec=self.fade_duration_sec,
                        loudness=(fused_mode == "loudness"),
                        defer_fetch=True,
                    )
                )
            ready = [m for buf, m in staged if buf is not None]
            metas = iter(dsp._fetch(torch.stack(ready)) if ready else ())
        out = []
        for buf, _ in staged:
            if buf is None:
                out.append((None, 0.0, True))
                continue
            meta = next(metas)
            audio = buf[: int(meta[0])]
            ratio = float(meta[1])
            if custom_decay:
                ratio, is_ok = self._validate_sound_decay(audio)
            else:
                is_ok = ratio >= self.sound_decay_threshold
            out.append((audio, ratio, is_ok))
        return out

    def _finalize_item(self, audio_segments: List):
        """Join segments, post-process, and compute the decay verdict.

        Returns (final_audio, decay_ratio, is_decay_ok); final_audio is
        None when joining failed. Uses the fused finalize when the provider
        allows it.
        """
        fused_mode = self._fused_finalize_mode()
        if fused_mode is not None:
            with profiling.stage("dsp/finalize_fused"):
                final_audio, decay_ratio = dsp.finalize_segments(
                    audio_segments,
                    self.sample_rate,
                    crossfade_duration_sec=self.crossfade_duration_sec,
                    inter_sentence_pause_sec=self.inter_sentence_pause_sec,
                    trim=self.trim_silence,
                    silence_threshold_db=self.silence_threshold_db,
                    fade_duration_sec=self.fade_duration_sec,
                    loudness=(fused_mode == "loudness"),
                )
            if final_audio is None:
                return None, 0.0, True
            custom_decay = self._has_custom_decay_validator()
            if custom_decay:
                decay_ratio, is_decay_ok = self._validate_sound_decay(final_audio)
            else:
                is_decay_ok = decay_ratio >= self.sound_decay_threshold
            return final_audio, decay_ratio, is_decay_ok

        with profiling.stage("dsp/segment_join"):
            final_audio = self._smooth_segment_join(audio_segments)
        if final_audio is None:
            return None, 0.0, True
        try:
            with profiling.stage("dsp/postprocess"):
                final_audio = self._post_process_audio(final_audio)
        except Exception as e:  # noqa: BLE001
            logger.warning(f"  Post-processing failed ({e}), using raw audio")
        decay_ratio, is_decay_ok = self._validate_sound_decay(final_audio)
        return final_audio, decay_ratio, is_decay_ok

    # -- Cross-item batched pipeline -------------------------------------------

    def _run_pipeline_batched_items(
        self,
        mapped_texts: List[str],
        token: CancellationToken,
        progress_callback: Optional[Callable[[str], None]] = None,
    ) -> List[Optional[Tuple[object, int, dict]]]:
        """Batched pipeline: ALL items' segments share device calls.

        Per-item semantics (validation gates, best-by-drift fallback, decay
        regeneration up to max_decay_retries, worst-case metadata) match
        the sequential pipeline; only the batching is wider — the flattened
        (item, segment) list is generated/validated together, and decay
        retries re-batch only the failing items.
        """
        n = len(mapped_texts)
        effective_max_chars = self._compute_max_chars()
        items_segments = [
            self._split_text_into_segments(t, effective_max_chars) for t in mapped_texts
        ]
        for idx, (t, segs) in enumerate(zip(mapped_texts, items_segments)):
            logger.info(
                f"Text item {idx + 1}: {len(t)} chars -> {len(segs)} segment(s)"
            )

        final_audio: List = [None] * n
        decay_ratio: List[float] = [0.0] * n
        item_drift: List[List[float]] = [[] for _ in range(n)]
        item_sim: List[List[float]] = [[] for _ in range(n)]
        seg_counts: List[int] = [0] * n

        active = [i for i in range(n) if items_segments[i]]

        for decay_attempt in range(self.max_decay_retries):
            if token.is_cancelled():
                raise CancelledException("Cancelled during batched pipeline")
            if decay_attempt > 0:
                self.seed = int(time.time() * 1000) % 100000
                logger.warning(
                    f"  Sound decay detected on {len(active)} item(s), regenerating "
                    f"(attempt {decay_attempt + 1}/{self.max_decay_retries})"
                )

            flat: List[str] = []
            spans: List[Tuple[int, int]] = []  # (item, n_segments)
            for i in active:
                flat.extend(items_segments[i])
                spans.append((i, len(items_segments[i])))

            gen_segments = (
                self._generate_segments_served
                if self.supports_serving_generation
                else self._generate_segments_batched
            )
            audios, pos_drift, pos_sim = gen_segments(flat, token, progress_callback)

            pos = 0
            next_active = []
            staged = []  # (item, segs_audio)
            for i, k in spans:
                segs_audio = [a for a in audios[pos : pos + k] if a is not None]
                drifts = [d for d in pos_drift[pos : pos + k] if d != float("inf")]
                sims = [x for x in pos_sim[pos : pos + k] if x is not None]
                pos += k

                if len(segs_audio) < k:
                    logger.error(
                        f"  Item {i + 1}: {k - len(segs_audio)} segment(s) failed"
                    )
                if not segs_audio:
                    final_audio[i] = None
                    continue
                item_drift[i] = drifts
                item_sim[i] = sims
                seg_counts[i] = len(segs_audio)
                staged.append((i, segs_audio))

            for i, (audio, ratio, decay_ok) in zip(
                (i for i, _ in staged),
                self._finalize_items([s for _, s in staged]),
            ):
                final_audio[i] = audio
                decay_ratio[i] = ratio
                if audio is None:
                    continue
                logger.info(
                    f"  Item {i + 1} sound decay ratio: {ratio:.3f} "
                    f"(threshold: {self.sound_decay_threshold})"
                )
                if not decay_ok:
                    next_active.append(i)

            active = next_active
            if not active:
                break
        else:
            for i in active:
                if final_audio[i] is not None:
                    logger.warning(
                        f"  Item {i + 1}: sound decay persisted after "
                        f"{self.max_decay_retries} attempt(s) "
                        f"(ratio={decay_ratio[i]:.3f}), returning best available audio"
                    )

        results: List[Optional[Tuple[object, int, dict]]] = []
        for i in range(n):
            if final_audio[i] is None:
                logger.error(f"Item {i + 1} failed: no audio generated")
                results.append(None)
                continue
            metadata: dict = {}
            if item_drift[i]:
                metadata["drift_prob"] = max(item_drift[i])
            if item_sim[i]:
                metadata["text_similarity"] = min(item_sim[i])
            metadata["decay_ratio"] = decay_ratio[i]
            results.append((final_audio[i], seg_counts[i], metadata))
        return results

    # -- Core pipeline ---------------------------------------------------------

    def _run_pipeline(
        self,
        texts: List[str],
        cancellation_token: CancellationToken,
        progress_callback: Optional[Callable[[str], None]] = None,
    ) -> List[Optional[Tuple[object, int, dict]]]:
        """Phonetic mapping → segmentation → generate/validate → join.

        Returns a list of (audio, segment_count, metadata) per text item,
        or None for failed items. Semantics parity: reference
        ``base_tts.py:708-956`` (decay outer loop, per-segment validation
        loop with best-by-drift tracking and for/else fallback).
        """
        token = cancellation_token
        mapped_texts = [self._apply_phonetic_mapping(t) for t in texts]
        results: List[Optional[Tuple[object, int, dict]]] = []

        logger.info(f"Generating audio for {len(mapped_texts)} text item(s)...")

        # Serving-backed providers take the batched-items path too: its
        # segment generation goes through _serving_submit (the slot batch),
        # never through a list-mode _generate_audio call.
        if self.supports_batch_generation or self.supports_serving_generation:
            return self._run_pipeline_batched_items(
                mapped_texts, token, progress_callback
            )

        for idx, text in enumerate(mapped_texts):
            if token.is_cancelled():
                raise CancelledException(f"Cancelled during text item {idx}")

            effective_max_chars = self._compute_max_chars()
            segments = self._split_text_into_segments(text, effective_max_chars)
            logger.info(
                f"Text item {idx + 1}: {len(text)} chars -> {len(segments)} segment(s)"
            )

            decay_thresh = self.sound_decay_threshold
            max_decay_retries = self.max_decay_retries
            final_audio = None
            audio_segments: List = []
            item_drift_scores: List[float] = []
            item_text_sim_scores: List[float] = []
            decay_ratio = 0.0
            is_decay_ok = True

            for decay_attempt in range(max_decay_retries):
                if decay_attempt > 0:
                    self.seed = int(time.time() * 1000) % 100000
                    logger.warning(
                        f"  Item {idx + 1}: sound decay detected, regenerating all "
                        f"segments (attempt {decay_attempt + 1}/{max_decay_retries})"
                    )

                audio_segments = []
                item_drift_scores = []
                item_text_sim_scores = []

                # Batch-capable providers never reach this loop: they return
                # via _run_pipeline_batched_items at the top of this method.
                for seg_idx, segment in enumerate(segments):
                    if token.is_cancelled():
                        raise CancelledException(
                            f"Cancelled during segment {seg_idx + 1} of item {idx + 1}"
                        )

                    logger.info(
                        f"  Segment {seg_idx + 1}/{len(segments)} ({len(segment)} chars)"
                    )
                    if progress_callback:
                        progress_callback(
                            f"Generating segment {seg_idx + 1}/{len(segments)}..."
                        )

                    # --- Retry/validation loop ---
                    self._set_seeds()
                    best_audio = None
                    best_drift = float("inf")
                    best_text_sim = None
                    last_audio = None

                    if self.candidates_per_iteration > 1 and self.max_iterations > 1:
                        best_audio, best_drift, best_text_sim = (
                            self._retry_segment_candidates(segment, token, seg_idx)
                        )
                        if best_audio is not None:
                            audio_segments.append(best_audio)
                            if best_drift != float("inf"):
                                item_drift_scores.append(best_drift)
                            if best_text_sim is not None:
                                item_text_sim_scores.append(best_text_sim)
                        else:
                            logger.error(f"  Segment {seg_idx + 1} failed to generate")
                        continue

                    for iteration in range(self.max_iterations):
                        if token.is_cancelled():
                            raise CancelledException(
                                f"Cancelled during iteration {iteration} of "
                                f"segment {seg_idx + 1}, item {idx + 1}"
                            )

                        if iteration > 0:
                            self.seed = int(time.time() * 1000) % 100000
                            self._set_seeds()

                        logger.info(f"    Iteration {iteration + 1}: seed {self.seed}")

                        try:
                            audio = self._generate_audio(segment)
                            last_audio = audio
                        except (ValueError, NotImplementedError):
                            raise  # config error — don't retry
                        except RuntimeError as e:
                            msg = str(e).lower()
                            if any(m in msg for m in _OOM_MARKERS):
                                logger.error(f"    Segment {seg_idx + 1} OOM: {e}")
                                self._free_device_memory()
                                continue
                            raise
                        except Exception as e:
                            logger.warning(
                                f"    Segment {seg_idx + 1}: generation error ({e})"
                            )
                            continue

                        # Skip validation when max_iterations == 1
                        if self.max_iterations == 1:
                            best_audio = audio
                            if getattr(self, "auto_sort_good_dir", None) or getattr(
                                self, "auto_sort_bad_dir", None
                            ):
                                # Drift detection just for auto-sort
                                try:
                                    drift_prob, _ = self._validate_accent_drift(
                                        audio, self.sample_rate
                                    )
                                    self._auto_sort_audio(audio, drift_prob)
                                except Exception as e:
                                    logger.warning(
                                        f"    Auto-sort drift check failed ({e})"
                                    )
                            break

                        try:
                            drift_prob, is_voice_ok = self._validate_accent_drift(
                                audio, self.sample_rate
                            )
                            self._auto_sort_audio(audio, drift_prob)

                            if drift_prob < best_drift:
                                best_drift = drift_prob
                                best_audio = audio
                                logger.info(f"      New best: drift {best_drift:.3f}")

                            is_text_ok = True
                            text_sim = 1.0

                            if is_voice_ok:
                                is_text_ok, text_sim, transcribed = self._validate_text_match(
                                    audio, self.sample_rate, segment
                                )
                                best_text_sim = text_sim
                                logger.info(
                                    f"      Text similarity: {text_sim:.3f} "
                                    f"(threshold: {self.text_similarity_threshold})"
                                )
                                if not is_text_ok and transcribed:
                                    try:
                                        self._log_text_diff(segment, transcribed)
                                    except Exception as e:
                                        logger.debug(f"Could not compute text diff: {e}")

                            if is_voice_ok and is_text_ok:
                                logger.info(
                                    f"    Segment {seg_idx + 1} valid after "
                                    f"{iteration + 1} iteration(s)"
                                )
                                best_audio = audio
                                break

                            reasons = []
                            if not is_voice_ok:
                                reasons.append(f"drift={drift_prob:.3f}")
                            if not is_text_ok:
                                reasons.append(f"text={text_sim:.3f}")
                            logger.warning(
                                f"    Segment {seg_idx + 1} invalid: "
                                f"{', '.join(reasons)}, retrying "
                                f"({iteration + 1}/{self.max_iterations})"
                            )
                        except Exception as e:
                            logger.warning(
                                f"    Segment {seg_idx + 1}: validation error ({e})"
                            )
                    else:  # for/else: loop exhausted without a break
                        if best_audio is not None:
                            logger.warning(
                                f"    Segment {seg_idx + 1}: max iterations reached, "
                                f"returning best (drift={best_drift:.3f})"
                            )
                        elif last_audio is not None:
                            best_audio = last_audio
                            logger.warning(
                                f"    Segment {seg_idx + 1}: max iterations reached, "
                                f"returning last audio"
                            )

                    if best_audio is not None:
                        audio_segments.append(best_audio)
                        if best_drift != float("inf"):
                            item_drift_scores.append(best_drift)
                        if best_text_sim is not None:
                            item_text_sim_scores.append(best_text_sim)
                    else:
                        logger.error(f"  Segment {seg_idx + 1} failed to generate")

                if not audio_segments:
                    break

                fused_mode = self._fused_finalize_mode()
                if fused_mode is not None:
                    # Fused: per-segment trim+DC → crossfade join →
                    # fades(+loudness)+decay with a single host fetch (the
                    # op-by-op chain fetches every trim's bounds).
                    with profiling.stage("dsp/finalize_fused"):
                        final_audio, decay_ratio = dsp.finalize_segments(
                            audio_segments,
                            self.sample_rate,
                            crossfade_duration_sec=self.crossfade_duration_sec,
                            inter_sentence_pause_sec=self.inter_sentence_pause_sec,
                            trim=self.trim_silence,
                            silence_threshold_db=self.silence_threshold_db,
                            fade_duration_sec=self.fade_duration_sec,
                            loudness=(fused_mode == "loudness"),
                        )
                    if final_audio is None:
                        break
                    # Custom/mocked decay validators still get the final say
                    custom_decay = self._has_custom_decay_validator()
                    if custom_decay:
                        decay_ratio, is_decay_ok = self._validate_sound_decay(final_audio)
                    else:
                        is_decay_ok = decay_ratio >= decay_thresh
                    logger.info(
                        f"  Item {idx + 1} sound decay ratio: {decay_ratio:.3f} "
                        f"(threshold: {decay_thresh})"
                    )
                    if is_decay_ok:
                        break
                    continue

                with profiling.stage("dsp/segment_join"):
                    final_audio = self._smooth_segment_join(audio_segments)

                if final_audio is None:
                    break

                try:
                    with profiling.stage("dsp/postprocess"):
                        final_audio = self._post_process_audio(final_audio)
                except Exception as e:
                    logger.warning(
                        f"  Item {idx + 1}: post-processing failed ({e}), using raw audio"
                    )

                # Validate sound decay on the full post-processed audio
                decay_ratio, is_decay_ok = self._validate_sound_decay(final_audio)
                logger.info(
                    f"  Item {idx + 1} sound decay ratio: {decay_ratio:.3f} "
                    f"(threshold: {decay_thresh})"
                )

                if is_decay_ok:
                    break
            else:
                if final_audio is not None and not is_decay_ok:
                    logger.warning(
                        f"  Item {idx + 1}: sound decay persisted after "
                        f"{max_decay_retries} attempt(s) "
                        f"(ratio={decay_ratio:.3f}, threshold={decay_thresh}), "
                        f"returning best available audio"
                    )

            if final_audio is None or not audio_segments:
                logger.error(f"Item {idx + 1} failed: no audio generated")
                results.append(None)
                continue

            metadata: dict = {}
            if item_drift_scores:
                metadata["drift_prob"] = max(item_drift_scores)
            if item_text_sim_scores:
                metadata["text_similarity"] = min(item_text_sim_scores)
            metadata["decay_ratio"] = decay_ratio
            results.append((final_audio, len(audio_segments), metadata))

        return results

    # -- Unified generate() ----------------------------------------------------

    def generate(
        self,
        texts: Union[str, List[str]],
        output_path: Optional[str] = None,
        cancellation_token: Optional[CancellationToken] = None,
        format: str = "wav",
        speed: float = 1.0,
        pitch_semitones: float = 0.0,
        progress_callback: Optional[Callable[[str], None]] = None,
    ) -> Union[Optional[GenerationResult], Optional[List[Optional[GenerationResult]]]]:
        """Generate audio from text.

        Accepts a single string or a list of strings. Applies phonetic
        mapping, splits long texts into segments, generates and validates
        each segment, and joins segments with crossfading.

        Args:
            texts: Text to synthesize — a single string or a list.
            output_path: Single-string mode: exact file path to write.
                List mode: base path; items saved as ``{output_path}_{idx}.wav``.
                ``None`` → in-memory only.
            cancellation_token: Optional token for cooperative cancellation.
            format: Output format ("wav", "mp3", "flac", "ogg").
            speed: Playback speed multiplier (1.0 = unchanged).
            pitch_semitones: Pitch shift in semitones (0.0 = unchanged).
            progress_callback: Optional callable receiving progress strings.

        Returns:
            Single mode: ``GenerationResult`` or ``None`` on failure.
            List mode: list of ``GenerationResult`` (``None`` for failed
            items), or ``None`` if all items failed.
        """
        if format not in _SUPPORTED_FORMATS:
            raise FormatConversionError(
                f"Unsupported format '{format}'. "
                f"Supported: {', '.join(sorted(_SUPPORTED_FORMATS))}"
            )

        _single_mode = isinstance(texts, str)
        if _single_mode:
            texts = [texts]

        try:
            token = cancellation_token or CancellationToken()

            pipeline_results = self._run_pipeline(texts, token, progress_callback)

            output_results: List[Optional[GenerationResult]] = []

            for idx, pipeline_item in enumerate(pipeline_results):
                if pipeline_item is None:
                    output_results.append(None)
                    continue

                final_audio, segments_count, metadata = pipeline_item

                if speed != 1.0 or pitch_semitones != 0.0:
                    final_audio = self._apply_speed_pitch(
                        final_audio, speed, pitch_semitones
                    )

                num_samples = int(np.prod(final_audio.shape))  # no host transfer
                duration_sec = num_samples / self.sample_rate

                result = GenerationResult(
                    audio=final_audio,
                    sample_rate=self.sample_rate,
                    duration_sec=duration_sec,
                    segments_count=segments_count,
                    format=format,
                    drift_prob=metadata.get("drift_prob"),
                    text_similarity=metadata.get("text_similarity"),
                    decay_ratio=metadata.get("decay_ratio"),
                )

                if output_path is not None:
                    try:
                        item_path = (
                            output_path if _single_mode else f"{output_path}_{idx}.wav"
                        )
                        if format != "wav":
                            wav_path = (
                                item_path.rsplit(".", 1)[0] + ".wav"
                                if "." in item_path
                                else item_path + ".wav"
                            )
                        else:
                            wav_path = item_path

                        self._save_wav(wav_path, final_audio, self.sample_rate)

                        if format != "wav":
                            item_path = self._convert_format(wav_path, format)

                        result.path = item_path
                        logger.info(f"Item {idx + 1} saved: {item_path}")
                    except FormatConversionError:
                        raise
                    except Exception as e:
                        logger.error(f"Failed to save audio for item {idx}: {e}")
                        result.path = None

                output_results.append(result)

            successful = sum(1 for r in output_results if r is not None)
            failed = len(output_results) - successful

            if failed > 0:
                logger.warning(
                    f"{failed}/{len(output_results)} text item(s) failed to generate"
                )

            if successful == 0:
                logger.error("All text items failed to generate")
                return None

            logger.info(
                f"Successfully generated {successful}/{len(output_results)} audio file(s)"
            )

            if _single_mode:
                return output_results[0]
            return output_results

        except CancelledException as e:
            logger.warning(f"Generation cancelled: {e}")
            return None
        except (FormatConversionError, ValueError, NotImplementedError):
            raise
        except Exception as e:
            logger.error(f"Error in TTS generation: {e}")
            traceback.print_exc()
            return None

    # -- Async API -------------------------------------------------------------

    async def async_generate(
        self,
        texts: Union[str, List[str]],
        output_path: Optional[str] = None,
        cancellation_token: Optional[CancellationToken] = None,
        format: str = "wav",
        speed: float = 1.0,
        pitch_semitones: float = 0.0,
        progress_callback: Optional[Callable[[str], None]] = None,
    ):
        """Async wrapper around generate(). Runs inference in a thread executor."""
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
                progress_callback=progress_callback,
            ),
        )

    # -- Streaming API ---------------------------------------------------------

    def stream(
        self,
        text: str,
        cancellation_token: Optional[CancellationToken] = None,
        speed: float = 1.0,
        pitch_semitones: float = 0.0,
        chunked: bool = True,
    ) -> Generator[GenerationResult, None, None]:
        """Yield one GenerationResult per text segment as generated.

        Unlike generate(), segments are not crossfaded or validated — each
        is trimmed/faded and yielded as soon as it's ready (reference
        semantics: ``src/rho_tts/base_tts.py:1132-1190``).

        Providers that implement :meth:`_stream_audio_chunks` (e.g. the
        Qwen codec-LM via ``stream_chunks``) additionally stream each
        segment as sub-segment chunks — first audio arrives after the first
        decode chunk (~constant latency regardless of segment length)
        instead of after the whole segment. Chunk mode is bypassed when
        speed/pitch shifting is requested (those transforms need the whole
        segment), or with ``chunked=False`` (for consumers whose contract
        is one result per text segment, e.g. the isolation worker's
        SEGMENT_RESULT protocol).
        """
        token = cancellation_token or CancellationToken()
        mapped_text = self._apply_phonetic_mapping(text)
        effective_max_chars = self._compute_max_chars()
        segments = self._split_text_into_segments(mapped_text, effective_max_chars)
        chunk_ok = chunked and speed == 1.0 and pitch_semitones == 0.0

        for seg_idx, segment in enumerate(segments):
            if token.is_cancelled():
                return

            self._set_seeds()
            if chunk_ok:
                try:
                    chunk_iter = self._stream_audio_chunks(segment, token)
                except Exception as e:  # noqa: BLE001
                    logger.warning(f"Segment {seg_idx + 1} failed: {e}")
                    continue
                if chunk_iter is not None:
                    try:
                        yield from self._stream_segment_chunks(
                            chunk_iter, token, seg_idx
                        )
                    except Exception as e:  # noqa: BLE001
                        # Same per-segment skip semantics as the
                        # non-chunked path below; the failed segment's
                        # tail is NOT emitted (see _stream_segment_chunks).
                        logger.warning(
                            f"Segment {seg_idx + 1} failed mid-stream: {e}"
                        )
                    continue
            try:
                raw = self._generate_audio(segment)
                audio = self._post_process_audio(raw)
            except Exception as e:
                logger.warning(f"Segment {seg_idx + 1} failed: {e}")
                continue

            audio = self._trim_silence(audio, from_start=True, from_end=True)
            audio = self._remove_dc_offset(audio)
            audio = self._apply_fades(audio, fade_in=True, fade_out=True)

            if speed != 1.0 or pitch_semitones != 0.0:
                audio = self._apply_speed_pitch(audio, speed, pitch_semitones)

            num_samples = int(np.prod(audio.shape))  # no host transfer

            yield GenerationResult(
                audio=audio,
                sample_rate=self.sample_rate,
                duration_sec=num_samples / self.sample_rate,
                segments_count=1,
                format="wav",
            )

    # -- Chunked streaming hooks (provider-optional) -----------------------

    def _stream_audio_chunks(
        self, text: str, cancellation_token: Optional[CancellationToken] = None
    ):
        """Optional provider hook: iterator of device waveform chunks.

        Return an iterator yielding raw waveform pieces for ONE segment as
        they decode (sub-segment granularity), or None when the provider
        has no incremental path — ``stream()`` then falls back to
        per-segment yields. The reference has no equivalent (its ``stream()`` granularity stops
        at segments, ``src/rho_tts/base_tts.py:1132-1190``).
        """
        return None

    def _make_chunk_postprocessor(self):
        """Per-chunk post-processing callable for chunked streaming.

        Providers whose ``_post_process_audio`` is global (e.g. Qwen's
        full-utterance loudness normalization) return a causal equivalent
        here (``dsp.StreamingLoudness``). Default: identity.
        """
        return lambda chunk: chunk

    def _stream_segment_chunks(self, chunk_iter, token, seg_idx: int):
        """Drive one segment's chunk iterator through streaming DSP.

        First chunk: leading-silence trim + fade-in. Last chunk (detected
        with one-chunk lookahead): trailing trim + fade-out. Every chunk
        passes through the provider's causal post-processor. DC-offset
        removal is skipped in chunk mode (it needs the full signal; codec
        output is DC-free to within fade tolerance).
        """
        post = self._make_chunk_postprocessor()
        first_pending = True
        prev = None
        try:
            for raw in chunk_iter:
                if token.is_cancelled():
                    return
                chunk = post(raw)
                if first_pending:
                    chunk = self._trim_silence(chunk, from_start=True, from_end=False)
                    chunk = self._apply_fades(chunk, fade_in=True, fade_out=False)
                    first_pending = False
                if prev is not None:
                    yield self._chunk_result(prev)
                prev = chunk
        except CancelledException:
            return
        except Exception as e:  # noqa: BLE001
            # Do NOT emit the held-back lookahead chunk: a mid-stream
            # failure must not masquerade as a cleanly finished segment
            # (trailing trim + fade-out would make the truncation sound
            # intentional). Propagate like the non-chunked path, where a
            # failed segment yields nothing.
            logger.warning(f"Segment {seg_idx + 1} chunk stream failed: {e}")
            raise
        if prev is not None and not token.is_cancelled():
            prev = self._trim_silence(prev, from_start=False, from_end=True)
            prev = self._apply_fades(prev, fade_in=False, fade_out=True)
            yield self._chunk_result(prev)

    def _chunk_result(self, audio) -> GenerationResult:
        num_samples = int(np.prod(audio.shape))
        return GenerationResult(
            audio=audio,
            sample_rate=self.sample_rate,
            duration_sec=num_samples / self.sample_rate,
            segments_count=1,
            format="wav",
        )

    @property
    @abstractmethod
    def sample_rate(self) -> int:
        """Sample rate for this TTS implementation."""
