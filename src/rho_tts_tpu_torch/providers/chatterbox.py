"""Chatterbox-class provider: the single-segment regeneration specialist, on the PyTorch port.

Counterpart of ``rho_tts_tpu/providers/chatterbox.py``. A high-retry
validation workflow (``max_iterations=50`` by default) around the
CFG-sampled AR model of :mod:`rho_tts_tpu_torch.models.chatterbox`.
Voice-prompt conditionals are cached per reference-audio path; the
"standard" and "faster" implementations differ only in decode caps. The
watermark is the on-device ``ops.watermark`` pass.

Sampling draws the JAX package's bits: each model call takes a fresh key
from the engine's threefry chain (:meth:`BaseTTS.next_rng`), so the same
seed gives the same tokens in both packages.

``parallelism`` ("data" or "tensor") starts the process group from the
environment before the model loads and puts it on a mesh of the world's
ranks (``parallel.enable_parallelism``), as ``QwenTTS`` does; both the
one-shot and the serving paths run meshed.

Capability parity: reference ``src/rho_tts/providers/chatterbox.py:21-167``
(constructor surface :45-102, prompt cache :113-121, faster caps :125-127,
watermarker gate :87-94).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Union

import numpy as np

from ..engine import BaseTTS
from ..provider_info import ProviderInfo, VoiceInfo

logger = logging.getLogger(__name__)


class ChatterboxTTS(BaseTTS):
    """Chatterbox-class TTS with comprehensive validation.

    Args:
        device: Device to run on ("cuda", "cuda:N" or "cpu").
        seed: Random seed for consistent voice generation.
        deterministic: cuDNN deterministic algorithms, no benchmarking.
        reference_audio: Audio path for voice cloning (optional; the default
            voice is used otherwise).
        implementation: "standard" or "faster" (capped decode); "tiny" is
            the test preset.
        max_chars_per_segment: Max characters per segment (default auto).
        max_iterations: Validation retry iterations (default 50).
        accent_drift_threshold: Accent-drift gate (default 0.17).
        text_similarity_threshold: STT match gate (default 0.75).
        drift_model_path: Explicit classifier path (overrides voice_id).
        phonetic_mapping: Word-to-pronunciation overrides.
        temperature: Sampling temperature (default 1.0).
        cfg_weight: Classifier-free guidance weight (default 0.6).
        quantization: "int8" or "int4" talker weights.
        model_path: Native checkpoint, or local T3 weights (a safetensors
            directory or ``t3_cfg.pt``); random weights when absent.
        min_audio_sec: Minimum generated duration (EOS masked below it).
        candidates_per_iteration: Validation retry candidates decoded per
            round in ONE CFG batch (2k rows); the validator accepts the
            first passing sample. Each round consumes k of
            ``max_iterations``.
        serving: Route pipeline segments through a continuous-batching
            :class:`~rho_tts_tpu_torch.serving_cb.ChatterboxServingEngine`:
            a segment that fails validation rejoins the running slot batch
            instead of waiting for the lockstep candidate loop.
        serving_slots: Concurrent requests in that engine's slot batch
            (transformer rows = 2x for the CFG pairs; default 4).
        serving_max_prompt: Engine prompt-token cap (default 128).
        serving_max_frames: Engine per-request frame cap (default 1024).
        parallelism: None (one GPU), "data" (replicated weights; serving
            slots over the ranks) or "tensor" (talker weights sharded over
            the mesh ``model`` axis). Both the one-shot and serving paths
            run meshed.
        n_devices: Mesh size (default: the world size).
    """

    MAX_MODEL_CHARS = 3000
    BYTES_PER_CHAR_ESTIMATE = 600_000

    def __init__(
        self,
        device: str = "cuda",
        seed: int = 789,
        deterministic: bool = False,
        reference_audio: Optional[str] = None,
        implementation: str = "standard",
        max_chars_per_segment: Optional[int] = None,
        max_iterations: int = 50,
        accent_drift_threshold: float = 0.17,
        text_similarity_threshold: float = 0.75,
        drift_model_path: Optional[str] = None,
        phonetic_mapping: Optional[Dict[str, str]] = None,
        temperature: float = 1.0,
        cfg_weight: float = 0.6,
        quantization: Optional[str] = None,
        model_path: Optional[str] = None,
        min_audio_sec: float = 0.0,
        candidates_per_iteration: int = 1,
        serving: bool = False,
        serving_slots: int = 4,
        serving_max_prompt: int = 128,
        serving_max_frames: int = 1024,
        parallelism: Optional[str] = None,
        n_devices: Optional[int] = None,
    ):
        super().__init__(device, seed, deterministic, phonetic_mapping=phonetic_mapping)

        if implementation not in ("standard", "faster", "tiny"):
            raise ValueError(
                f"Invalid implementation '{implementation}'. Must be 'standard' or 'faster'"
            )

        self.reference_audio_path = reference_audio
        self.voice_cloning = reference_audio is not None
        self.implementation = implementation
        self.drift_model_path = drift_model_path
        self.max_iterations = max_iterations
        self.accent_drift_threshold = accent_drift_threshold
        self.text_similarity_threshold = text_similarity_threshold
        self._max_chars_explicit = max_chars_per_segment is not None
        self.max_chars_per_segment = max_chars_per_segment or 800

        # Sampling knobs forwarded into the CFG decode
        self.temperature = temperature
        self.cfg_weight = cfg_weight
        self.min_audio_sec = min_audio_sec
        if candidates_per_iteration < 1:
            raise ValueError("candidates_per_iteration must be >= 1")
        self.candidates_per_iteration = int(candidates_per_iteration)

        #: Serving mode: pipeline segments submit to a shared
        #: ChatterboxServingEngine slot batch and validate as they retire
        #: (engine ``_generate_segments_served``).
        self.supports_serving_generation = bool(serving)
        self.serving_slots = serving_slots
        self.serving_max_prompt = serving_max_prompt
        self.serving_max_frames = serving_max_frames
        self._serving = None

        # The model loads eagerly: this provider's workflow is "many fast
        # regenerations of one segment", so the first generate() must not
        # pay the load.
        from ..models.chatterbox import ChatterboxModel

        if parallelism not in (None, "data", "tensor"):
            raise ValueError(f"Unknown parallelism mode: {parallelism!r}")
        self.parallelism = parallelism
        self.n_devices = n_devices
        if parallelism:
            from ..parallel.mesh import initialize_distributed

            initialize_distributed(device=self.device)  # this rank's GPU first
        self.model = ChatterboxModel.from_pretrained(
            device=device, implementation=implementation, seed=seed,
            quantization=quantization, model_path=model_path,
        )
        if parallelism:
            from ..parallel import enable_parallelism

            enable_parallelism(self.model, parallelism, n_devices)
        self._prompt_cache: Dict[str, np.ndarray] = {}

        if self.voice_cloning:
            self._init_reference_embedding(reference_audio)

    def _init_reference_embedding(self, reference_audio: str) -> None:
        """Embed the reference voice once for similarity validation."""
        try:
            from ..audio_io import load_wav

            wav, sr = load_wav(reference_audio)
            self.reference_embedding = self.model.speaker_encoder.embed_utterance(wav, sr)
        except Exception as exc:  # noqa: BLE001 — similarity is best-effort
            logger.warning("Reference embedding unavailable: %s", exc)

    def _prime_conditionals(self) -> dict:
        """Load the (cached) voice conditionals into the model and return the
        sampling kwargs shared by every generate / stream entry point."""
        prompt_path = self.reference_audio_path if self.voice_cloning else None
        if prompt_path:
            if prompt_path not in self._prompt_cache:
                self._prompt_cache[prompt_path] = self.model.prepare_conditionals(prompt_path)
            self.model.conditionals = np.array(self._prompt_cache[prompt_path], copy=True)

        gen_kwargs = dict(temperature=self.temperature, cfg_weight=self.cfg_weight)
        if self.min_audio_sec > 0:
            gen_kwargs["min_new_tokens"] = int(
                self.min_audio_sec * self.model.cfg.codec.frame_rate
            )
        return gen_kwargs

    def _generate_audio(self, text: Union[str, List[str]], **kwargs):
        """Generate audio (on the model's device) with per-reference
        conditionals caching."""
        if isinstance(text, list):
            return [self._generate_audio(t, **kwargs) for t in text]

        gen_kwargs = self._prime_conditionals()
        gen_kwargs.update(kwargs)
        return self.model.generate(text, audio_prompt_path=None, rng=self.next_rng(),
                                   **gen_kwargs)

    def _generate_audio_candidates(self, text: str, k: int) -> List:
        """k independent samples of one segment in a single CFG batch."""
        gen_kwargs = self._prime_conditionals()
        return self.model.generate_candidates(text, k, audio_prompt_path=None,
                                              rng=self.next_rng(), **gen_kwargs)

    def _serving_engine(self):
        """Lazily build and start the continuous-batching serving engine."""
        if self._serving is None:
            from ..serving_cb import ChatterboxServingEngine

            self._serving = ChatterboxServingEngine(
                self.model, n_slots=self.serving_slots, max_prompt=self.serving_max_prompt,
                max_frames=self.serving_max_frames, seed=self.seed,
            )
            self._serving.start()
        return self._serving

    def _serving_submit(self, text: str):
        """Submit one pipeline segment to the serving engine. The cached
        reference-voice embedding is primed on the model, which the engine's
        admission takes when a request names no reference audio."""
        self._prime_conditionals()
        eng = self._serving_engine()
        min_frames = int(self.min_audio_sec * self.model.cfg.codec.frame_rate)
        # The "faster" preset's decode cap.
        max_frames = self.model.cfg.max_new_tokens
        return eng.submit(text, cfg_weight=self.cfg_weight, temperature=self.temperature,
                          min_frames=min_frames, max_frames=max_frames)

    def _stream_audio_chunks(self, text: str, cancellation_token=None):
        """Chunked streaming through the model's sliding-window vocoder; the
        position-indexed watermark keeps the concatenated stream equal to
        the one-shot path's."""
        kw = self._prime_conditionals()
        cancel_check = cancellation_token.raise_if_cancelled if cancellation_token else None
        gen = self.model.stream_chunks(text, audio_prompt_path=None, rng=self.next_rng(),
                                       cancel_check=cancel_check, **kw)
        return (wav for wav, _sr in gen)

    def close(self) -> None:
        """Release the model's parameters, the serving engine and the
        conditionals (device memory)."""
        super().close()
        if self._serving is not None:
            self._serving.close()
            self._serving = None
        self.model = None
        self._prompt_cache.clear()
        self._free_device_memory()

    @classmethod
    def provider_info(cls) -> ProviderInfo:
        return ProviderInfo(
            name="chatterbox",
            supports_voice_cloning=True,
            supported_languages=["English"],
            builtin_voices=[VoiceInfo(id="default", name="Default", language="English")],
        )

    @property
    def sample_rate(self) -> int:
        return self.model.sr
