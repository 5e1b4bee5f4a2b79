"""Qwen3-TTS-class provider: the default backend, on the PyTorch port.

Counterpart of ``rho_tts_tpu/providers/qwen.py``. Wraps
:class:`rho_tts_tpu_torch.models.qwen.QwenTTSModel` behind the
:class:`~rho_tts_tpu_torch.engine.BaseTTS` engine: voice cloning with
Base-model paths (reference audio + transcript) and named speakers with
CustomVoice-model paths, batch generation, the 3-pass loudness
post-processing on the device, chunked streaming, the validation loop
(the reference voice's speaker embedding is computed when a voice-clone
model loads), continuous-batching serving (``serving=True``: segments go
through a ``ServingEngine`` slot batch and validate as they retire) and
single-segment speculative decoding (``draft_model_path``).

Sampling draws the JAX package's bits: each model call takes a fresh key
from the engine's threefry chain (:meth:`BaseTTS.next_rng`) and turns it
into per-row seeds with ``_derive_row_seeds``, so the same seed gives the
same codes in both packages.

A per-voice LoRA adapter (``lora_path``, ``models.qwen.lora``) is merged
into the dense weights at load, before quantization.

``parallelism`` ("data" or "tensor") starts the process group from the
environment (``torchrun``; ``parallel.mesh.initialize_distributed``)
before the model loads, so it lands on this rank's GPU, and puts the
loaded model on a mesh of the world's ranks (``parallel.enable_parallelism``;
a world of one warns and stays unmeshed). Every rank calls ``generate``
with the same inputs and gets the whole result.

Capability parity: reference ``src/rho_tts/providers/qwen.py:22-413``
(constructor surface :48-94, routing :218-266, post-processing :268-378,
config-driven max-chars refinement :131-139).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Union

import numpy as np

from ..engine import BaseTTS
from ..ops import dsp
from ..provider_info import ProviderInfo, VoiceInfo

logger = logging.getLogger(__name__)

DEFAULT_MODEL = "Qwen/Qwen3-TTS-12Hz-1.7B-Base"

class QwenTTS(BaseTTS):
    """Qwen3-TTS-class implementation with batch processing and validation.

    Args:
        device: Device to run on ("cuda", "cuda:N" or "cpu").
        seed: Random seed for consistent voice generation.
        deterministic: cuDNN deterministic algorithms, no benchmarking.
        reference_audio: Reference audio path for voice cloning (optional).
        reference_text: Transcript of the reference audio (required when
            reference_audio is set).
        speaker: Named speaker for CustomVoice model paths.
        language: Synthesis language (default "English").
        model_path: Native checkpoint dir, HF safetensors dir or model id
            (size inferred from the name: 0.6B / 1.7B / tiny; a name that
            is no directory runs with random weights from ``seed``).
        max_chars_per_segment: Max characters per text segment
            (default: auto-computed from free device memory).
        batch_size: Texts per batched model call (default 5).
        max_iterations: Validation retry iterations (default 10).
        accent_drift_threshold: Accent-drift gate (default 0.17).
        text_similarity_threshold: STT match gate (default 0.85).
        sound_decay_threshold: Min last/first RMS ratio (default 0.3).
        drift_model_path: Explicit drift-classifier path (overrides the
            per-voice lookup).
        phonetic_mapping: Word-to-pronunciation overrides.
        quantization: "int8" or "int4" talker weights.
        min_audio_sec: Minimum generated duration (EOS masked below it).
        parallelism: None (one GPU), "data" (replicated weights, batch
            rows over the ranks) or "tensor" (talker weights sharded over
            the mesh ``model`` axis for checkpoints that exceed one GPU).
        n_devices: Mesh size for parallel serving (default: the world size).
        draft_model_path: a smaller checkpoint (or preset) used as the
            speculative-decoding draft of single-segment generations: it
            proposes ``speculative_gamma`` codec tokens a round and the
            target verifies them in one forward.
        speculative_gamma: draft tokens proposed per round (default 4).
        speculative_residual_mode: "draft" (accepted slots carry the
            draft's residual codebooks) or "strict" (the target's, with
            acceptance truncated where they disagree).
        lora_path: per-voice LoRA adapter directory
            (``models.qwen.lora.save_lora``), merged at load, before
            quantization.
        serving: route the pipeline's segments through a continuous-batching
            ``ServingEngine``: a failed segment rejoins the running slot
            batch at once instead of waiting for the iteration barrier.
        serving_slots: slot-batch size of that engine (default 8).
        serving_max_prompt: its prompt-token cap (default 512).
        serving_max_frames: its per-request frame cap (default 1024).
    """

    MAX_MODEL_CHARS = 4000
    BYTES_PER_CHAR_ESTIMATE = 500_000
    # One batched device call synthesizes all segments of an item.
    supports_batch_generation = True
    # _post_process_audio is exactly the standard loudness chain, so the
    # finalize may run fused.
    post_process_is_loudness = True

    def __init__(
        self,
        device: str = "cuda",
        seed: int = 789,
        deterministic: bool = False,
        reference_audio: Optional[str] = None,
        reference_text: Optional[str] = None,
        speaker: Optional[str] = None,
        language: str = "English",
        model_path: str = DEFAULT_MODEL,
        max_chars_per_segment: Optional[int] = None,
        batch_size: int = 5,
        max_iterations: int = 10,
        accent_drift_threshold: float = 0.17,
        text_similarity_threshold: float = 0.85,
        sound_decay_threshold: float = 0.3,
        drift_model_path: Optional[str] = None,
        phonetic_mapping: Optional[Dict[str, str]] = None,
        quantization: Optional[str] = None,
        min_audio_sec: float = 0.0,
        parallelism: Optional[str] = None,
        n_devices: Optional[int] = None,
        draft_model_path: Optional[str] = None,
        speculative_gamma: int = 4,
        speculative_residual_mode: str = "draft",
        lora_path: Optional[str] = None,
        serving: bool = False,
        serving_slots: int = 8,
        serving_max_prompt: int = 512,
        serving_max_frames: int = 1024,
    ):
        super().__init__(device, seed, deterministic, phonetic_mapping=phonetic_mapping)
        if parallelism not in (None, "data", "tensor"):
            raise ValueError(f"Unknown parallelism mode: {parallelism!r}")
        self.parallelism = parallelism
        self.n_devices = n_devices

        if reference_audio is not None and reference_text is None:
            raise ValueError(
                "reference_text (transcript of reference audio) is required "
                "when reference_audio is set"
            )

        self.reference_audio_path = reference_audio
        self.reference_text = reference_text
        self.speaker = speaker
        self.language = language
        self.voice_cloning = reference_audio is not None
        self.model_path = model_path
        self.drift_model_path = drift_model_path
        self.quantization = quantization
        self.min_audio_sec = min_audio_sec
        self.draft_model_path = draft_model_path
        self.speculative_gamma = speculative_gamma
        if speculative_residual_mode not in ("draft", "strict"):
            raise ValueError(
                f"Unknown speculative_residual_mode: {speculative_residual_mode!r}"
            )
        self.speculative_residual_mode = speculative_residual_mode
        #: per-voice LoRA adapter dir merged at load, before quantization
        self.lora_path = lora_path
        self._draft_model = None

        #: Continuous-batching pipeline mode (engine ``_generate_segments_served``);
        #: retries draw fresh per-request seeds from the serving engine.
        self.supports_serving_generation = bool(serving)
        self.serving_slots = serving_slots
        self.serving_max_prompt = serving_max_prompt
        self.serving_max_frames = serving_max_frames
        self._serving = None

        self._max_chars_explicit = max_chars_per_segment is not None
        self.max_chars_per_segment = (
            max_chars_per_segment if max_chars_per_segment is not None else 1000
        )
        self.batch_size = batch_size
        self.force_sentence_split = False
        self.max_iterations = max_iterations
        self.accent_drift_threshold = accent_drift_threshold
        self.text_similarity_threshold = text_similarity_threshold
        self.sound_decay_threshold = sound_decay_threshold

        # Model is lazy-loaded on first generation
        self._model = None
        self._reference_embedding_initialized = False

    # -- Model management ---------------------------------------------------

    def _load_model(self):
        if self._model is None:
            from ..models.qwen import QwenTTSModel

            logger.info("Loading Qwen-TTS model '%s'...", self.model_path)
            if self.parallelism:
                from ..parallel.mesh import initialize_distributed

                initialize_distributed(device=self.device)  # this rank's GPU first
            self._model = QwenTTSModel.from_pretrained(
                self.model_path, seed=self.seed, quantization=self.quantization,
                device=self.device, lora_path=self.lora_path,
            )
            self._enable_mesh(self._model)
            # Refine max model chars from the checkpoint's context length
            mpe = self._model.config.max_position_embeddings
            if mpe:
                self._max_model_chars = min(self.MAX_MODEL_CHARS, mpe)
            if self.voice_cloning:
                self._initialize_reference_embedding()
        return self._model

    def _load_draft(self):
        """Lazy-load the speculative-decoding draft model."""
        if self._draft_model is None:
            from ..models.qwen import QwenTTSModel

            logger.info("Loading speculative draft '%s'...", self.draft_model_path)
            self._draft_model = QwenTTSModel.from_pretrained(
                self.draft_model_path, seed=self.seed, quantization=self.quantization,
                device=self.device,
            )
        return self._draft_model

    def _enable_mesh(self, model):
        """Switch the loaded model to multi-GPU serving if requested:
        ``"data"`` replicates the weights and spreads batch rows over the
        ranks; ``"tensor"`` shards the talker weights over the mesh
        ``model`` axis, with any leftover ranks forming a ``data`` axis."""
        if not self.parallelism:
            return
        from ..parallel import enable_parallelism

        enable_parallelism(model, self.parallelism, self.n_devices)

    def _initialize_reference_embedding(self):
        """Compute the reference speaker embedding for similarity checks."""
        if self._reference_embedding_initialized:
            return
        try:
            from ..audio_io import load_wav

            wav, sr = load_wav(self.reference_audio_path)
            self.reference_embedding = np.asarray(
                self.speaker_encoder.embed_utterance(wav, sr)
            )
            self._reference_embedding_initialized = True
            logger.info("Reference voice embedding computed")
        except Exception as exc:  # noqa: BLE001 — similarity is best-effort
            logger.warning("Speaker embedding unavailable: %s", exc)

    def _is_custom_voice(self) -> bool:
        """CustomVoice vs Base routing.

        Parity: the reference infers it from "CustomVoice" in the model
        path (``src/rho_tts/providers/qwen.py:218-266``). Native serving
        checkpoints carry the variant in their manifest instead.
        """
        if "CustomVoice" in self.model_path:
            return True
        try:
            from ..models import checkpoint as ckpt_lib

            if ckpt_lib.is_native_checkpoint(self.model_path):
                return ckpt_lib.load_manifest(self.model_path).get("variant") == "custom-voice"
        except Exception:  # noqa: BLE001
            return False
        return False

    def _route(self):
        """(model, model kwargs of the voice) for the routed variant.

        CustomVoice paths require a named speaker; Base paths require
        reference audio (reference parity).
        """
        model = self._load_model()
        if self._is_custom_voice():
            if not self.speaker:
                raise ValueError(
                    "CustomVoice model requires a named speaker. Select a built-in "
                    "voice (e.g. Vivian, Ryan) or provide reference audio with a "
                    "Base model for voice cloning."
                )
            voice = dict(speaker=self.speaker, ref_audio=None, ref_text=None)
        else:
            if not self.voice_cloning:
                raise ValueError(
                    "Qwen Base model requires reference audio for voice cloning. "
                    "Use a CustomVoice model with a named speaker, or provide "
                    "reference audio."
                )
            voice = dict(speaker=None, ref_audio=self.reference_audio_path,
                         ref_text=self.reference_text)
        voice.update(language=self.language,
                     min_frames=int(self.min_audio_sec * model.config.codec.frame_rate))
        return model, voice

    # -- Generation ----------------------------------------------------------

    def _generate_audio(self, text: Union[str, List[str]], **kwargs):
        """One batched model call; waveforms stay on the model's device.

        Row seeds come from the engine's key chain as in the JAX package
        (``_derive_row_seeds(next_rng(), n)``). With a draft model and no
        ``parallelism``, a single text takes speculative decoding from the
        next key; under ``parallelism`` it runs the (meshed) batch, as in the
        JAX package, whether or not the world turned out to have one rank.
        """
        from ..models.qwen.model import _derive_row_seeds

        model, voice = self._route()
        is_single = isinstance(text, str)
        text_list = [text] if is_single else list(text)
        if len(text_list) == 1 and self.draft_model_path and not self.parallelism:
            # Single-segment latency path: draft-verify speculative decode
            wav, _sr = model.synthesize_speculative(
                text_list[0], self._load_draft(), gamma=self.speculative_gamma,
                rng=self.next_rng(), residual_mode=self.speculative_residual_mode, **voice,
            )
            return wav if is_single else [wav]
        seeds = _derive_row_seeds(self.next_rng(), len(text_list))
        waves, _sr = model.synthesize(text_list, seeds=seeds, **voice)
        return waves[0] if is_single else waves

    def _serving_engine(self):
        """Lazily build and start the continuous-batching serving engine."""
        if self._serving is None:
            from ..serving import ServingEngine

            self._serving = ServingEngine(
                self._load_model(), n_slots=self.serving_slots,
                max_prompt=self.serving_max_prompt, max_frames=self.serving_max_frames,
                seed=self.seed,
            )
            self._serving.start()
        return self._serving

    def _serving_submit(self, text: str):
        """Submit one pipeline segment to the serving engine (the routing of
        :meth:`_generate_audio`: CustomVoice needs a named speaker, Base
        reference audio)."""
        _model, voice = self._route()
        return self._serving_engine().submit(text, **voice)

    def _post_process_audio(self, audio):
        """Decay-corrected loudness normalization + soft clip (on the device).

        Parity: reference ``qwen.py:268-378``; implemented as
        :func:`rho_tts_tpu_torch.ops.dsp.loudness_postprocess`.
        """
        return dsp.loudness_postprocess(audio, self.sample_rate)

    def _stream_audio_chunks(self, text: str, cancellation_token=None):
        """Chunked streaming via the codec-LM's sliding-window vocoder.

        Single-stream only: ``parallelism`` and speculative decoding keep
        per-segment streaming (None: the engine falls back), as in the JAX
        package."""
        from ..models.qwen.model import _derive_row_seeds

        if self.parallelism or self.draft_model_path:
            return None
        model, voice = self._route()
        cancel_check = cancellation_token.raise_if_cancelled if cancellation_token else None
        seed = int(_derive_row_seeds(self.next_rng(), 1)[0])
        gen = model.stream_chunks(text, seed=seed, cancel_check=cancel_check, **voice)
        return (wav for wav, _sr in gen)

    def _make_chunk_postprocessor(self):
        """Causal analogue of the global loudness pass for chunk mode."""
        return dsp.StreamingLoudness().process

    def export_checkpoint(self, path: str) -> None:
        """Export the loaded model as a native serving checkpoint.

        Pre-quantized when the provider runs quantized, so a later
        ``QwenTTS(model_path=path)`` loads the exact serving bytes (see
        ``models.checkpoint``). Offline conversion:
        ``python -m rho_tts_tpu_torch.models.qwen.export``.
        """
        self._load_model().save_checkpoint(path)

    def close(self) -> None:
        """Stop the serving engine, release the models' parameters (device memory)."""
        super().close()
        if self._serving is not None:
            try:
                self._serving.close()
            except Exception:  # noqa: BLE001
                logger.exception("serving engine close failed")
            self._serving = None
        self._model = None
        self._draft_model = None
        self._free_device_memory()

    @classmethod
    def provider_info(cls) -> ProviderInfo:
        from ..models.qwen.model import SPEAKERS

        return ProviderInfo(
            name="qwen",
            supports_voice_cloning=True,
            supported_languages=["English", "Chinese", "Japanese", "Korean"],
            builtin_voices=[VoiceInfo(id=n, name=n, language="English") for n in SPEAKERS],
        )

    @property
    def sample_rate(self) -> int:
        if self._model is not None:
            return self._model.sample_rate
        from ..models.qwen.config import resolve_config

        return resolve_config(self.model_path).codec.sample_rate
