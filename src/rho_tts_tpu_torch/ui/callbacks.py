"""UI callbacks: generation, CRUD, parameter/phonetic persistence, training.

Pure-Python (no gradio imports) so the whole layer is unit-testable; the
Blocks app in ``app.py`` wires these to widgets.

Counterpart of ``rho_tts_tpu/ui/callbacks.py``, on the port's factory,
classifier trainer and classifier cache.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
import uuid
from typing import Dict, Generator, Iterable, List, Optional, Tuple

from . import config as cfgmod
from .config import GenerationRecord, ModelConfig, VoiceProfile
from .state import AppState

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------


def validate_generation_request(state: AppState, model_id: str, voice_id: str, text: str):
    """Return (model, voice, error). Routing guards mirror the providers'."""
    if not text or not text.strip():
        return None, None, "Enter some text to synthesize."
    model = state.config.get_model(model_id)
    if model is None:
        return None, None, f"Unknown model: {model_id}"
    voice = state.config.get_voice(voice_id)
    if voice is None:
        return None, None, f"Unknown voice: {voice_id}"
    if model.provider == "qwen":
        if model.needs_reference and not voice.is_cloning:
            return None, None, (
                "This Qwen Base model needs a cloning voice with reference audio. "
                "Pick a cloning voice or switch to a CustomVoice model."
            )
        if not model.needs_reference and not voice.speaker and not voice.is_cloning:
            return None, None, (
                "This CustomVoice model needs a named speaker voice (e.g. Vivian)."
            )
    return model, voice, None


def generate_audio(
    state: AppState,
    model_id: str,
    voice_id: str,
    text: str,
    fmt: str = "wav",
    speed: float = 1.0,
    pitch_semitones: float = 0.0,
    output_dir: Optional[str] = None,
) -> Generator[Tuple[Optional[str], str], None, None]:
    """Run one generation; yields (audio_path, status_message) updates.

    Generation runs in a worker thread; progress messages stream through a
    queue so the UI stays live and the Cancel button works.
    """
    model, voice, err = validate_generation_request(state, model_id, voice_id, text)
    if err:
        yield None, f"❌ {err}"
        return

    try:
        tts = state.get_or_create_tts(model, voice)
    except Exception as exc:  # noqa: BLE001
        logger.exception("TTS construction failed")
        yield None, f"❌ Failed to load model: {exc}"
        return

    token = state.new_cancellation_token()
    out_dir = output_dir or cfgmod.OUTPUTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"gen_{uuid.uuid4().hex[:10]}.{fmt}")

    progress: "queue.Queue[Optional[str]]" = queue.Queue()
    result_box: Dict[str, object] = {}

    def run():
        try:
            result_box["result"] = tts.generate(
                text,
                out_path,
                cancellation_token=token,
                format=fmt,
                speed=speed,
                pitch_semitones=pitch_semitones,
                progress_callback=progress.put,
            )
        except Exception as exc:  # noqa: BLE001
            result_box["error"] = exc
        finally:
            progress.put(None)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    yield None, "⏳ Generating..."
    while True:
        msg = progress.get()
        if msg is None:
            break
        yield None, f"⏳ {msg}"
    thread.join()

    if "error" in result_box:
        yield None, f"❌ Generation failed: {result_box['error']}"
        return

    result = result_box.get("result")
    if result is None:
        if token.is_cancelled():
            yield None, "🚫 Generation cancelled."
        else:
            yield None, "❌ Generation failed (see logs)."
        return

    record = GenerationRecord.new(
        text=text,
        voice_id=voice.id,
        model_id=model.id,
        output_path=result.path,
        duration_sec=result.duration_sec,
        format=fmt,
        speed=speed,
        pitch_semitones=pitch_semitones,
        drift_prob=result.drift_prob,
        text_similarity=result.text_similarity,
    )
    state.add_record(record)
    state.config.last_voice_id = voice.id
    state.config.last_model_id = model.id
    state.save()

    scores = []
    if result.drift_prob is not None:
        scores.append(f"drift {result.drift_prob:.2f}")
    if result.text_similarity is not None:
        scores.append(f"similarity {result.text_similarity:.2f}")
    suffix = f" ({', '.join(scores)})" if scores else ""
    yield result.path, f"✅ Done — {result.duration_sec:.1f}s audio{suffix}"


def cancel_generation(state: AppState) -> str:
    state.cancel_generation()
    return "🚫 Cancelling..."


# ---------------------------------------------------------------------------
# Parameter overrides (fallback chain: saved → model defaults)
# ---------------------------------------------------------------------------


def load_parameters(state: AppState, voice_id: str, model_id: str) -> Dict:
    """Effective parameters: model defaults overlaid with saved overrides."""
    model = state.config.get_model(model_id)
    params = dict(model.default_params) if model else {}
    params.update(state.config.get_parameter_override(voice_id, model_id))
    return params


def save_parameters(state: AppState, voice_id: str, model_id: str, params: Dict) -> str:
    """Persist only values differing from the model defaults."""
    model = state.config.get_model(model_id)
    defaults = model.default_params if model else {}
    override = {k: v for k, v in params.items() if defaults.get(k) != v}
    key = state.config.composite_key(voice_id, model_id)
    if override:
        state.config.parameter_overrides[key] = override
    else:
        state.config.parameter_overrides.pop(key, None)
    state.save()
    state.invalidate_tts()
    return "✅ Parameters saved."


def reset_parameters(state: AppState, voice_id: str, model_id: str) -> Dict:
    key = state.config.composite_key(voice_id, model_id)
    state.config.parameter_overrides.pop(key, None)
    state.save()
    state.invalidate_tts()
    return load_parameters(state, voice_id, model_id)


# ---------------------------------------------------------------------------
# Phonetic mappings
# ---------------------------------------------------------------------------


def load_phonetic_rows(state: AppState, voice_id: str, model_id: str) -> List[List[str]]:
    mapping = state.config.get_phonetic_mapping(voice_id, model_id)
    return [[k, v] for k, v in mapping.items()]


def save_phonetic_rows(
    state: AppState, voice_id: str, model_id: str, rows: Iterable[Iterable[str]]
) -> str:
    mapping = {}
    for row in rows or []:
        if not row:
            continue
        word = (row[0] or "").strip() if len(row) > 0 else ""
        sub = (row[1] or "").strip() if len(row) > 1 else ""
        if word and sub:
            mapping[word] = sub
    key = state.config.composite_key(voice_id, model_id)
    if mapping:
        state.config.phonetic_mappings[key] = mapping
    else:
        state.config.phonetic_mappings.pop(key, None)
    state.save()
    state.invalidate_tts()
    return f"✅ Saved {len(mapping)} phonetic mapping(s)."


# ---------------------------------------------------------------------------
# Voice CRUD
# ---------------------------------------------------------------------------


def add_voice(
    state: AppState,
    name: str,
    provider: str,
    reference_audio: Optional[str] = None,
    reference_text: Optional[str] = None,
    speaker: Optional[str] = None,
    language: str = "English",
) -> Tuple[Optional[VoiceProfile], str]:
    if not name or not name.strip():
        return None, "❌ Voice name is required."
    if any(v.name == name for v in state.config.voices):
        return None, f"❌ A voice named '{name}' already exists."
    if reference_audio and not reference_text and provider == "qwen":
        return None, "❌ Reference text (transcript) is required for Qwen cloning voices."

    voice_id = f"voice-{uuid.uuid4().hex[:8]}"
    stored = None
    if reference_audio:
        try:
            stored = cfgmod.store_voice_audio(reference_audio, voice_id)
        except Exception as exc:  # noqa: BLE001
            return None, f"❌ Could not store reference audio: {exc}"

    voice = VoiceProfile(
        id=voice_id,
        name=name.strip(),
        provider=provider,
        speaker=speaker or None,
        reference_audio=stored,
        reference_text=reference_text or None,
        language=language,
    )
    state.config.voices.append(voice)
    state.save()
    return voice, f"✅ Voice '{name}' added."


def delete_voice(state: AppState, voice_id: str) -> str:
    voice = state.config.get_voice(voice_id)
    if voice is None:
        return "❌ Voice not found."
    if voice.is_builtin:
        return "❌ Built-in voices cannot be deleted."
    state.config.voices = [v for v in state.config.voices if v.id != voice_id]
    # Cascade: drop this voice's mappings and overrides
    prefix = f"{voice_id}::"
    state.config.phonetic_mappings = {
        k: v for k, v in state.config.phonetic_mappings.items() if not k.startswith(prefix)
    }
    state.config.parameter_overrides = {
        k: v for k, v in state.config.parameter_overrides.items() if not k.startswith(prefix)
    }
    if voice.reference_audio and os.path.exists(voice.reference_audio):
        try:
            os.remove(voice.reference_audio)
        except OSError:
            pass
    state.save()
    state.invalidate_tts()
    return f"✅ Voice '{voice.name}' deleted."


def voice_choices_for_model(state: AppState, model_id: str) -> List[Tuple[str, str]]:
    """(label, voice_id) choices filtered by model compatibility.

    Qwen Base (cloning) models hide built-in named speakers; CustomVoice
    models hide cloning voices; Chatterbox shows its default + cloning
    voices.
    """
    model = state.config.get_model(model_id)
    if model is None:
        return [(v.name, v.id) for v in state.config.voices]
    out = []
    for v in state.config.voices:
        if model.provider == "qwen":
            if model.needs_reference and not v.is_cloning:
                continue
            if not model.needs_reference and v.is_cloning:
                continue
            if v.provider != "qwen":
                continue
        elif model.provider == "chatterbox":
            if v.provider not in ("chatterbox", "qwen"):
                continue
            if v.provider == "qwen" and not v.is_cloning:
                continue  # named qwen speakers don't transfer
        out.append((v.name, v.id))
    return out


# ---------------------------------------------------------------------------
# Model CRUD
# ---------------------------------------------------------------------------


def add_model(
    state: AppState,
    label: str,
    provider: str,
    model_path: str,
    needs_reference: bool = False,
    default_params: Optional[Dict] = None,
) -> Tuple[Optional[ModelConfig], str]:
    if not label or not model_path:
        return None, "❌ Label and model path are required."
    if any(m.model_path == model_path and m.provider == provider for m in state.config.models):
        return None, f"❌ Model '{model_path}' is already registered."
    model = ModelConfig(
        id=f"model-{uuid.uuid4().hex[:8]}",
        label=label,
        provider=provider,
        model_path=model_path,
        needs_reference=needs_reference,
        default_params=default_params or {},
    )
    state.config.models.append(model)
    state.save()
    return model, f"✅ Model '{label}' added."


def delete_model(state: AppState, model_id: str) -> str:
    model = state.config.get_model(model_id)
    if model is None:
        return "❌ Model not found."
    state.config.models = [m for m in state.config.models if m.id != model_id]
    suffix = f"::{model_id}"
    state.config.phonetic_mappings = {
        k: v for k, v in state.config.phonetic_mappings.items() if not k.endswith(suffix)
    }
    state.config.parameter_overrides = {
        k: v for k, v in state.config.parameter_overrides.items() if not k.endswith(suffix)
    }
    state.save()
    state.invalidate_tts()
    return f"✅ Model '{model.label}' deleted."


def model_serving_details(state: AppState, model_id: str) -> Optional[Dict]:
    """Current GPU serving knobs for a model (defaults when unset)."""
    m = state.config.get_model(model_id)
    if m is None:
        return None
    p = m.default_params or {}
    return {
        # Reflect the EFFECTIVE default when unset: the provider
        # constructor default is quantization=None (bf16). Fabricating
        # "int8" here would make a Load-then-Save silently quantize a
        # model the user never asked to quantize.
        "quantization": p.get("quantization") or "bf16",
        "parallelism": p.get("parallelism") or "none",
        "draft_model_path": p.get("draft_model_path") or "",
        "speculative_gamma": int(p.get("speculative_gamma", 4)),
        "lora_path": p.get("lora_path") or "",
        "serving": bool(p.get("serving", False)),
    }


def set_model_serving(
    state: AppState,
    model_id: str,
    quantization: str,
    parallelism: str,
    draft_model_path: str = "",
    speculative_gamma: int = 4,
    lora_path: str = "",
    serving: bool = False,
) -> str:
    """Persist per-model GPU serving knobs (quantization / DP-TP / draft).

    The deployment-relevant choices on the GPU: weight precision
    (bf16/int8/int4; int4 runs the hand-written int4 kernel), mesh
    parallelism for serving over several GPUs (one process per GPU), a
    draft model for speculative decoding, a LoRA adapter, and the
    continuous-batching engine. Stored in ``default_params`` so they flow
    through ``AppState.build_tts_kwargs`` into the provider constructor.
    """
    m = state.config.get_model(model_id)
    if m is None:
        return "❌ Select a model first."
    if quantization not in ("bf16", "int8", "int4"):
        return f"❌ Unknown quantization: {quantization!r}"
    if parallelism not in ("none", "data", "tensor"):
        return f"❌ Unknown parallelism mode: {parallelism!r}"
    p = dict(m.default_params or {})
    p["quantization"] = quantization
    p["parallelism"] = parallelism
    p["draft_model_path"] = (draft_model_path or "").strip()
    p["speculative_gamma"] = int(speculative_gamma)
    p["lora_path"] = (lora_path or "").strip()
    p["serving"] = bool(serving)
    m.default_params = p
    state.save()
    state.invalidate_tts()
    return f"✅ Serving config for '{m.label}' saved."


def download_model(model_path: str) -> str:
    """Prefetch a model from the HuggingFace Hub into the local cache."""
    if cfgmod.is_model_cached(model_path):
        return f"✅ '{model_path}' is already available locally."
    try:
        from huggingface_hub import snapshot_download
    except ImportError:
        return "❌ huggingface_hub is not installed; cannot download."
    try:
        snapshot_download(model_path)
        return f"✅ Downloaded '{model_path}'."
    except Exception as exc:  # noqa: BLE001
        return f"❌ Download failed: {exc}"


# ---------------------------------------------------------------------------
# Library
# ---------------------------------------------------------------------------


def library_model_choices(state: AppState) -> List:
    """Models present in history as (label, id) choices; '' = all.

    The Library tab's model filter.
    """
    seen = {}
    for r in state.history:
        if r.model_id not in seen:
            model = state.config.get_model(r.model_id)
            seen[r.model_id] = model.label if model else r.model_id
    return [("All models", "")] + [(label, mid) for mid, label in seen.items()]


def library_voice_choices(state: AppState) -> List:
    """Voices present in history as (label, id) choices; '' = all.

    The Library tab's voice filter.
    """
    seen = {}
    for r in state.history:
        if r.voice_id not in seen:
            voice = state.config.get_voice(r.voice_id)
            seen[r.voice_id] = voice.name if voice else r.voice_id
    return [("All voices", "")] + [(name, vid) for vid, name in seen.items()]


def library_rows(
    state: AppState,
    search: str = "",
    voice_filter: Optional[str] = None,
    model_filter: Optional[str] = None,
) -> List[List[str]]:
    """History as table rows (newest first), filtered by text/voice/model."""
    rows = []
    needle = (search or "").lower()
    for r in sorted(state.history, key=lambda r: r.timestamp, reverse=True):
        if needle and needle not in r.text.lower():
            continue
        if voice_filter and r.voice_id != voice_filter:
            continue
        if model_filter and r.model_id != model_filter:
            continue
        voice = state.config.get_voice(r.voice_id)
        model = state.config.get_model(r.model_id)
        rows.append(
            [
                r.id,
                time.strftime("%Y-%m-%d %H:%M", time.localtime(r.timestamp)),
                (r.text[:60] + "…") if len(r.text) > 60 else r.text,
                voice.name if voice else r.voice_id,
                model.label if model else r.model_id,
                f"{r.duration_sec:.1f}s",
            ]
        )
    return rows


def replay_record(state: AppState, record_id: str) -> Tuple[Optional[str], str]:
    record = state.get_record(record_id)
    if record is None:
        return None, "❌ Record not found."
    if not record.output_path or not os.path.exists(record.output_path):
        return None, "❌ Audio file no longer exists (re-generate it)."
    return record.output_path, f"▶ {record.text[:60]}"


def library_get_audio(
    state: AppState, record_id: str
) -> Tuple[Optional[str], str]:
    """(playable path or None, full transcript) for a selected row.

    A row select loads playback and the full transcript pane.
    """
    record = state.get_record(record_id)
    if record is None:
        return None, ""
    path = record.output_path
    if not path or not os.path.exists(path):
        path = None
    return path, record.text


def delete_record(state: AppState, record_id: str) -> str:
    record = state.get_record(record_id)
    if record is None:
        return "❌ Record not found."
    if record.output_path and os.path.exists(record.output_path):
        try:
            os.remove(record.output_path)
        except OSError:
            pass
    state.delete_record(record_id)
    return "✅ Record deleted."


def clear_history(state: AppState) -> str:
    """Delete every history record (and its audio files)."""
    for r in list(state.history):
        if r.output_path and os.path.exists(r.output_path):
            try:
                os.remove(r.output_path)
            except OSError:
                pass
    n = state.clear_history()
    return f"✅ Cleared {n} record(s)." if n else "History already empty."


# ---------------------------------------------------------------------------
# Classifier training
# ---------------------------------------------------------------------------


def train_classifier(
    state: AppState, dataset_dir: str, voice_id: Optional[str] = None
) -> Generator[str, None, None]:
    """Stream training progress lines; runs the trainer in a thread."""
    if not dataset_dir or not os.path.isdir(dataset_dir):
        yield "❌ Dataset directory not found."
        return
    log_q: "queue.Queue[Optional[str]]" = queue.Queue()
    outcome: Dict[str, object] = {}

    def run():
        try:
            from ..validation.classifier.trainer import train

            outcome["path"] = train(
                dataset_dir, voice_id=voice_id, progress_callback=log_q.put
            )
        except Exception as exc:  # noqa: BLE001
            outcome["error"] = exc
        finally:
            log_q.put(None)

    threading.Thread(target=run, daemon=True).start()

    lines: List[str] = []
    while True:
        msg = log_q.get()
        if msg is None:
            break
        lines.append(msg)
        yield "\n".join(lines)

    if "error" in outcome:
        lines.append(f"❌ Training failed: {outcome['error']}")
    else:
        from ..validation.classifier import clear_cache

        clear_cache()
        lines.append(f"✅ Training complete: {outcome.get('path')}")
    yield "\n".join(lines)


def voice_details(state: AppState, voice_id: str) -> Dict:
    """Fields for the Edit Voice form (empty dict when not found)."""
    v = state.config.get_voice(voice_id)
    if v is None:
        return {}
    return {
        "name": v.name,
        "language": v.language,
        "reference_text": v.reference_text or "",
        "is_builtin": v.is_builtin,
    }


def edit_voice(
    state: AppState,
    voice_id: str,
    new_name: Optional[str] = None,
    language: Optional[str] = None,
    reference_text: Optional[str] = None,
) -> str:
    """Update an existing voice profile. Built-in voices are read-only."""
    v = state.config.get_voice(voice_id)
    if v is None:
        return "❌ Select a voice to edit."
    if v.is_builtin:
        return "❌ Built-in voices cannot be edited."
    if new_name and new_name.strip():
        clash = any(o.name == new_name.strip() and o.id != v.id for o in state.config.voices)
        if clash:
            return f"❌ A voice named '{new_name.strip()}' already exists."
        v.name = new_name.strip()
    if language:
        v.language = language
    if reference_text is not None:
        v.reference_text = reference_text.strip() or None
    state.save()
    state.invalidate_tts()
    return f"✅ Voice '{v.name}' updated."


def catalog_choices(provider: str) -> List[Tuple[str, str]]:
    """(label, catalog id) pairs for the provider's model catalog."""
    return [
        (e["label"], e["id"]) for e in cfgmod.PROVIDER_MODELS.get(provider, [])
    ]


def catalog_entry(provider: str, entry_id: str) -> Optional[Dict]:
    """Catalog defaults for one entry (path, needs_reference, params)."""
    for e in cfgmod.PROVIDER_MODELS.get(provider, []):
        if e["id"] == entry_id:
            return dict(e)
    return None


def add_model_from_catalog(
    state: AppState,
    provider: str,
    entry_id: str,
    custom_label: Optional[str] = None,
    max_iterations: Optional[int] = None,
    accent_drift_threshold: Optional[float] = None,
    text_similarity_threshold: Optional[float] = None,
) -> Tuple[Optional[ModelConfig], str]:
    """Register a model from the provider catalog, merging the catalog's
    defaults with any per-model quality-control overrides."""
    entry = catalog_entry(provider, entry_id)
    if entry is None:
        return None, "❌ Pick a model from the catalog."
    params = dict(entry.get("default_params", {}))
    if max_iterations is not None:
        params["max_iterations"] = int(max_iterations)
    if accent_drift_threshold is not None:
        params["accent_drift_threshold"] = float(accent_drift_threshold)
    if text_similarity_threshold is not None:
        params["text_similarity_threshold"] = float(text_similarity_threshold)
    return add_model(
        state,
        label=(custom_label or entry["label"]).strip(),
        provider=provider,
        model_path=entry["model_path"],
        needs_reference=bool(entry.get("needs_reference", False)),
        default_params=params,
    )


def model_details(state: AppState, model_id: str) -> Dict:
    """Fields for the Edit Model form (empty dict when not found)."""
    m = state.config.get_model(model_id)
    if m is None:
        return {}
    p = m.default_params or {}
    return {
        "label": m.label,
        "max_iterations": p.get("max_iterations", 10),
        "accent_drift_threshold": p.get("accent_drift_threshold", 0.17),
        "text_similarity_threshold": p.get("text_similarity_threshold", 0.85),
    }


def edit_model(
    state: AppState,
    model_id: str,
    label: Optional[str] = None,
    max_iterations: Optional[int] = None,
    accent_drift_threshold: Optional[float] = None,
    text_similarity_threshold: Optional[float] = None,
) -> str:
    """Update a registered model's label / quality-control parameters."""
    m = state.config.get_model(model_id)
    if m is None:
        return "❌ Select a model to edit."
    if label and label.strip():
        m.label = label.strip()
    p = dict(m.default_params or {})
    if max_iterations is not None:
        p["max_iterations"] = int(max_iterations)
    if accent_drift_threshold is not None:
        p["accent_drift_threshold"] = float(accent_drift_threshold)
    if text_similarity_threshold is not None:
        p["text_similarity_threshold"] = float(text_similarity_threshold)
    m.default_params = p
    state.save()
    state.invalidate_tts()
    return f"✅ Model '{m.label}' updated."
