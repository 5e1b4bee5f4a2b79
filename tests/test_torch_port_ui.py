"""Port parity of the UI's plain-Python layers: config, state, session, callbacks.

Each check runs the same inputs through ``rho_tts_tpu.ui`` and
``rho_tts_tpu_torch.ui`` and compares what comes out:

* config: a config and a history one package wrote load in the other and
  save back byte for byte, both ways; the port keeps its own directory;
* ``AppState.build_tts_kwargs``: equal dicts over a grid of provider x
  voice x overrides x serving sentinels;
* the engine cache closes the old engine before it builds the new one;
  ``SessionContext`` isolates config, history, cancellation and files;
* the callbacks of ``tests/test_ui_callbacks.py`` as scenarios, with uuid4
  counted from zero in both packages, so their outputs and the configs
  they leave are equal;
* ``generate_audio`` on the tiny fp32 weights in both packages (engines
  injected as ``test_torch_port_provider.py`` does): WAVs within 1e-4 + 1
  int16 LSB.
"""

import itertools
import json
import os
import sys
import types
import uuid
from unittest.mock import MagicMock, patch

import numpy as np
import pytest
import torch

import rho_tts_tpu.ui.callbacks as jcb
import rho_tts_tpu.ui.config as jcfg
import rho_tts_tpu.ui.session as jsession
import rho_tts_tpu.ui.state as jstate
import rho_tts_tpu_torch.ui.callbacks as tcb
import rho_tts_tpu_torch.ui.config as tcfg
import rho_tts_tpu_torch.ui.session as tsession
import rho_tts_tpu_torch.ui.state as tstate
from rho_tts_tpu.result import GenerationResult as JResult
from rho_tts_tpu_torch.result import GenerationResult as TResult

UI = {"jax": types.SimpleNamespace(cb=jcb, cfg=jcfg, state=jstate, session=jsession,
                                   Result=JResult, mod="rho_tts_tpu"),
      "torch": types.SimpleNamespace(cb=tcb, cfg=tcfg, state=tstate, session=tsession,
                                     Result=TResult, mod="rho_tts_tpu_torch")}
LSB = 1.0 / 32768


@pytest.fixture(autouse=True)
def _isolated_paths(tmp_path, monkeypatch):
    monkeypatch.setenv(tcfg.CONFIG_ENV, str(tmp_path / "config.json"))
    monkeypatch.setenv(tcfg.HISTORY_ENV, str(tmp_path / "history.json"))


# ---------------------------------------------------------------------------
# Config files, both ways
# ---------------------------------------------------------------------------


def _rich_config(cfgmod):
    cfg = cfgmod.AppConfig()
    cfg.voices.append(cfgmod.VoiceProfile(id="voice-1", name="Clone — ü", provider="qwen",
                                          reference_audio="/r.wav", reference_text="t"))
    cfg.models.append(cfgmod.ModelConfig(id="model-1", label="Mine", provider="qwen",
                                         model_path="/ckpt", needs_reference=True,
                                         default_params={"quantization": "int4",
                                                         "parallelism": "tensor",
                                                         "speculative_gamma": 3}))
    cfg.phonetic_mappings["voice-1::model-1"] = {"GIF": "jif"}
    cfg.parameter_overrides["voice-1::model-1"] = {"max_iterations": 2, "seed": 5}
    cfg.last_voice_id, cfg.last_model_id = "voice-1", "model-1"
    return cfg


def _records(cfgmod):
    return [cfgmod.GenerationRecord(id="r1", text="hello", voice_id="voice-1",
                                    model_id="model-1", output_path="/o.wav", timestamp=12.5,
                                    duration_sec=1.25, drift_prob=0.1, text_similarity=0.9),
            cfgmod.GenerationRecord(id="r2", text="two", voice_id="v", model_id="m",
                                    output_path=None, timestamp=13.0, format="mp3", speed=1.5)]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_config_and_history_round_trip_byte_equal(writer, reader, tmp_path, monkeypatch):
    w, r = UI[writer].cfg, UI[reader].cfg
    w.save_config(_rich_config(w))
    w.save_history(_records(w))
    written = {p: open(os.environ[p], "rb").read() for p in (tcfg.CONFIG_ENV, tcfg.HISTORY_ENV)}
    cfg, hist = r.load_config(), r.load_history()
    assert cfg.get_voice("voice-1").name == "Clone — ü" and hist[1].format == "mp3"
    monkeypatch.setenv(tcfg.CONFIG_ENV, str(tmp_path / "again.json"))
    monkeypatch.setenv(tcfg.HISTORY_ENV, str(tmp_path / "again_history.json"))
    r.save_config(cfg)
    r.save_history(hist)
    assert open(tmp_path / "again.json", "rb").read() == written[tcfg.CONFIG_ENV]
    assert open(tmp_path / "again_history.json", "rb").read() == written[tcfg.HISTORY_ENV]


def test_config_module_matches_jax_but_its_directory():
    assert tcfg.PROVIDER_MODELS == jcfg.PROVIDER_MODELS
    assert tcfg.QWEN_BUILTIN_SPEAKERS == jcfg.QWEN_BUILTIN_SPEAKERS
    assert (tcfg.CONFIG_ENV, tcfg.HISTORY_ENV) == (jcfg.CONFIG_ENV, jcfg.HISTORY_ENV)
    assert tcfg.AppConfig().to_dict() == jcfg.AppConfig().to_dict()
    assert tcfg.APP_DIR == os.path.join(os.path.expanduser("~"), ".rho_tts_tpu_torch")
    for name in ("VOICES_DIR", "DATASETS_DIR", "OUTPUTS_DIR"):
        assert getattr(tcfg, name).startswith(tcfg.APP_DIR + os.sep)
    assert tcfg.APP_DIR != jcfg.APP_DIR


def test_corrupt_files_fall_back_as_in_jax(tmp_path):
    for path in (os.environ[tcfg.CONFIG_ENV], os.environ[tcfg.HISTORY_ENV]):
        with open(path, "w") as f:
            f.write("{not json")
    assert tcfg.load_config().to_dict() == jcfg.load_config().to_dict()
    assert tcfg.load_history() == jcfg.load_history() == []
    assert tcfg.is_model_cached(str(tmp_path)) and not tcfg.is_model_cached("no/such-model-x")


# ---------------------------------------------------------------------------
# build_tts_kwargs over a grid
# ---------------------------------------------------------------------------

MODELS = {
    "qwen-base": dict(id="m-base", label="Base", provider="qwen", model_path="Qwen/T-Base",
                      needs_reference=True),
    "qwen-custom": dict(id="m-cv", label="CV", provider="qwen", model_path="Qwen/T-CustomVoice"),
    "chatterbox": dict(id="m-cb", label="CB", provider="chatterbox",
                       model_path="chatterbox-standard"),
}
VOICES = {
    "clone": dict(id="v-clone", name="Clone", provider="qwen", reference_audio="/ref.wav",
                  reference_text="transcript", language="German"),
    "speaker": dict(id="v-ryan", name="Ryan", provider="qwen", speaker="Ryan"),
    "chatterbox": dict(id="v-cb", name="CB", provider="chatterbox"),
}
OVERRIDES = {
    "none": {},
    "mixed": {"implementation": "faster", "temperature": 0.7, "cfg_weight": 0.3,
              "speaker": "X", "batch_size": 3, "sound_decay_threshold": 0.2,
              "n_devices": 2, "max_iterations": 4, "seed": 9},
}
SERVING = {
    "unset": {},
    "sentinels": {"quantization": "", "parallelism": "", "draft_model_path": "",
                  "lora_path": ""},
    "bf16_none": {"quantization": "bf16", "parallelism": "none", "speculative_gamma": 4,
                  "serving": False},
    "none_quant": {"quantization": "none"},
    "set": {"quantization": "int4", "parallelism": "tensor", "draft_model_path": "/draft",
            "speculative_gamma": 6, "lora_path": "/lora", "serving": True},
}


@pytest.mark.parametrize("model,voice,override,serving",
                         list(itertools.product(MODELS, VOICES, OVERRIDES, SERVING)))
def test_build_tts_kwargs_equal_jax(model, voice, override, serving):
    out = {}
    for pkg, ui in UI.items():
        cfg = ui.cfg.AppConfig()
        m = ui.cfg.ModelConfig(**MODELS[model], default_params={"max_iterations": 10,
                                                                **SERVING[serving]})
        v = ui.cfg.VoiceProfile(**VOICES[voice])
        cfg.models.append(m)
        cfg.voices.append(v)
        cfg.parameter_overrides[cfg.composite_key(v.id, m.id)] = dict(OVERRIDES[override])
        cfg.phonetic_mappings[cfg.composite_key(v.id, m.id)] = {"GIF": "jif"}
        out[pkg] = ui.state.AppState(config=cfg, multi_user=True).build_tts_kwargs(m, v)
    assert out["torch"] == out["jax"]
    assert out["torch"]["phonetic_mapping"] == {"GIF": "jif"}


def test_state_filters_match_jax():
    assert tstate._CHATTERBOX_ONLY_PARAMS == jstate._CHATTERBOX_ONLY_PARAMS
    assert tstate._QWEN_ONLY_PARAMS == jstate._QWEN_ONLY_PARAMS


# ---------------------------------------------------------------------------
# Engine cache, sessions
# ---------------------------------------------------------------------------


def test_engine_cache_closes_the_old_engine_before_building_the_new():
    state = tstate.AppState(config=tcfg.AppConfig(), multi_user=True)
    m1, m2 = state.config.models[0], state.config.models[1]
    voice = state.config.voices[0]
    events, engines = [], []

    def build(provider, **kwargs):
        eng = MagicMock()
        eng.close.side_effect = lambda: events.append(("close", engines.index(eng)))
        engines.append(eng)
        events.append(("build", len(engines) - 1))
        return eng

    with patch("rho_tts_tpu_torch.factory.TTSFactory.get_tts_instance", side_effect=build):
        a = state.get_or_create_tts(m1, voice)
        assert state.get_or_create_tts(m1, voice) is a  # cached on (voice, model)
        b = state.get_or_create_tts(m2, voice)
        state.invalidate_tts()
        state.invalidate_tts()
    assert a is not b and a.voice_id == voice.id
    assert events == [("build", 0), ("close", 0), ("build", 1), ("close", 1)]
    assert state._tts is None and state._tts_key is None


def test_engine_cache_survives_a_failing_close():
    state = tstate.AppState(config=tcfg.AppConfig(), multi_user=True)
    bad = MagicMock()
    bad.close.side_effect = RuntimeError("device gone")
    with patch("rho_tts_tpu_torch.factory.TTSFactory.get_tts_instance",
               side_effect=[bad, MagicMock()]):
        state.get_or_create_tts(state.config.models[0], state.config.voices[0])
        state.get_or_create_tts(state.config.models[1], state.config.voices[0])
    bad.close.assert_called_once()


def test_sessions_are_isolated(tmp_path):
    base = tcfg.AppConfig()
    s1, s2 = tsession.SessionContext(base), tsession.SessionContext(base)
    s1.state.config.voices.append(tcfg.VoiceProfile(id="only-s1", name="X"))
    assert s2.state.config.get_voice("only-s1") is None and base.get_voice("only-s1") is None
    s1.state.add_record(tcfg.GenerationRecord.new(text="a", voice_id="v", model_id="m",
                                                  output_path=None))
    assert (len(s1.state.history), len(s2.state.history)) == (1, 0)
    t1, t2 = s1.state.new_cancellation_token(), s2.state.new_cancellation_token()
    s1.state.cancel_generation()
    assert t1.is_cancelled() and not t2.is_cancelled()
    d = s1.output_dir
    assert os.path.isdir(d) and os.path.basename(d).startswith("rho_tts_tpu_torch_session_")
    s1.state.save()  # multi-user: never persisted
    assert not os.path.exists(os.environ[tcfg.CONFIG_ENV])
    s1.cleanup()
    s1.cleanup()
    assert not os.path.exists(d) and s1._output_dir is None


# ---------------------------------------------------------------------------
# The callbacks as scenarios, equal in both packages
# ---------------------------------------------------------------------------


def _custom(state):
    return next(m.id for m in state.config.models if m.provider == "qwen"
                and not m.needs_reference)


def _base(state):
    return next(m.id for m in state.config.models if m.provider == "qwen" and m.needs_reference)


def _cbm(state):
    return next(m.id for m in state.config.models if m.provider == "chatterbox")


def sc_validation(ui, state, tmp):
    out = []
    for mid in [m.id for m in state.config.models] + ["nope"]:
        for vid in [v.id for v in state.config.voices][:3] + ["builtin-chatterbox-default",
                                                              "nope"]:
            for text in ("hi", "  "):
                m, v, err = ui.cb.validate_generation_request(state, mid, vid, text)
                out.append([m and m.id, v and v.id, err])
    return out


def _fake_engine(ui, mode):
    tts = MagicMock()

    def generate(text, out_path, cancellation_token=None, progress_callback=None, **kw):
        progress_callback("Generating segment 1/1...")
        if mode == "fails":
            return None
        if mode == "raises":
            raise RuntimeError("device exploded")
        if mode == "cancel":
            cancellation_token.cancel()
            return None
        return ui.Result(path=out_path, audio=None, sample_rate=24000, duration_sec=1.2,
                         segments_count=1, drift_prob=0.05, text_similarity=0.97)

    tts.generate.side_effect = generate
    return tts


def sc_generate_flow(ui, state, tmp):
    out = []
    for mode in ("ok", "fails", "raises", "cancel", "load_error"):
        if mode == "load_error":
            getter = patch.object(state, "get_or_create_tts", side_effect=OSError("no weights"))
        else:
            getter = patch.object(state, "get_or_create_tts",
                                  return_value=_fake_engine(ui, mode))
        with getter:
            out.append(list(ui.cb.generate_audio(state, _custom(state), "builtin-vivian",
                                                 "hello", fmt="wav", speed=1.5,
                                                 pitch_semitones=2.0, output_dir=str(tmp))))
    out.append(list(ui.cb.generate_audio(state, _base(state), "builtin-vivian", "x")))
    out.append(ui.cb.cancel_generation(state))
    out.append([r.__dict__ | {"timestamp": 0} for r in state.history])
    return out


def sc_parameters(ui, state, tmp):
    vid, mid = "builtin-vivian", _custom(state)
    out = [ui.cb.load_parameters(state, vid, mid)]
    p = dict(out[0], max_iterations=3, seed=42)
    out.append(ui.cb.save_parameters(state, vid, mid, p))
    out.append(ui.cb.load_parameters(state, vid, mid))
    out.append(ui.cb.save_parameters(state, vid, mid, dict(out[0])))
    out.append(ui.cb.reset_parameters(state, vid, mid))
    out.append(ui.cb.load_parameters(state, vid, "nope"))
    return out


def sc_phonetics(ui, state, tmp):
    vid, mid = "builtin-vivian", _custom(state)
    out = [ui.cb.save_phonetic_rows(state, vid, mid, [["GIF", "jif"], ["", "x"], ["y", ""],
                                                      [], [" SQL ", " sequel "], ["z"]])]
    out.append(ui.cb.load_phonetic_rows(state, vid, mid))
    out.append(ui.cb.save_phonetic_rows(state, vid, mid, None))
    out.append(ui.cb.load_phonetic_rows(state, vid, mid))
    return out


def sc_voices(ui, state, tmp):
    ref = tmp / "ref.wav"
    ref.write_bytes(b"RIFF-fake")
    out = [ui.cb.add_voice(state, "", "qwen")[1],
           ui.cb.add_voice(state, "Vivian", "qwen")[1],
           ui.cb.add_voice(state, "NoText", "qwen", reference_audio=str(ref))[1]]
    v, msg = ui.cb.add_voice(state, "Mine", "qwen", reference_audio=str(ref),
                             reference_text="hello", language="French")
    out += [msg, v.id, os.path.basename(v.reference_audio)]
    cb_voice, msg = ui.cb.add_voice(state, "CbVoice", "chatterbox", reference_audio=str(ref))
    out.append(msg)
    state.config.phonetic_mappings[f"{v.id}::m"] = {"a": "b"}
    state.config.parameter_overrides[f"{v.id}::m"] = {"seed": 1}
    out += [ui.cb.voice_details(state, v.id), ui.cb.voice_details(state, "nope"),
            ui.cb.edit_voice(state, v.id, new_name="CbVoice"),
            ui.cb.edit_voice(state, v.id, new_name="Renamed", language="Spanish",
                             reference_text="  "),
            ui.cb.edit_voice(state, "builtin-vivian", new_name="x"),
            ui.cb.edit_voice(state, "nope"),
            ui.cb.voice_details(state, v.id)]
    for mid in [m.id for m in state.config.models] + ["nope"]:
        out.append(ui.cb.voice_choices_for_model(state, mid))
    out += [ui.cb.delete_voice(state, "builtin-vivian"), ui.cb.delete_voice(state, "nope"),
            ui.cb.delete_voice(state, v.id), os.path.exists(v.reference_audio),
            ui.cb.delete_voice(state, cb_voice.id)]
    return out


def sc_models(ui, state, tmp):
    out = [ui.cb.add_model(state, "", "qwen", "")[1],
           ui.cb.add_model(state, "Dup", "qwen", "Qwen/Qwen3-TTS-12Hz-1.7B-Base")[1]]
    m, msg = ui.cb.add_model(state, "Local", "qwen", "/ckpt", needs_reference=True,
                             default_params={"max_iterations": 2})
    out += [msg, m.id]
    for provider in ("qwen", "chatterbox", "nope"):
        out.append(ui.cb.catalog_choices(provider))
    out += [ui.cb.catalog_entry("qwen", "qwen-0.6b-base"), ui.cb.catalog_entry("qwen", "x")]
    out.append(ui.cb.add_model_from_catalog(state, "chatterbox", "chatterbox-faster")[1])
    out.append(ui.cb.delete_model(state, "chatterbox-faster"))
    m2, msg = ui.cb.add_model_from_catalog(state, "chatterbox", "chatterbox-faster",
                                           custom_label=" Fast ", max_iterations=7,
                                           accent_drift_threshold=0.2,
                                           text_similarity_threshold=0.6)
    out += [msg, m2.default_params, ui.cb.add_model_from_catalog(state, "qwen", "x")[1]]
    state.config.phonetic_mappings[f"v::{m.id}"] = {"a": "b"}
    out += [ui.cb.model_details(state, m.id), ui.cb.model_details(state, "nope"),
            ui.cb.edit_model(state, m.id, label="Edited", max_iterations=4,
                             accent_drift_threshold=0.3, text_similarity_threshold=0.5),
            ui.cb.edit_model(state, "nope"), ui.cb.model_details(state, m.id),
            ui.cb.delete_model(state, m.id), ui.cb.delete_model(state, "nope")]
    return out


def sc_serving(ui, state, tmp):
    mid = _custom(state)
    out = [ui.cb.model_serving_details(state, mid), ui.cb.model_serving_details(state, "nope")]
    out.append(ui.cb.set_model_serving(state, mid, "int4", "tensor", " /draft ", 6, " /lora ",
                                       True))
    out.append(ui.cb.model_serving_details(state, mid))
    out += [ui.cb.set_model_serving(state, mid, "fp8", "none"),
            ui.cb.set_model_serving(state, mid, "int8", "pipeline"),
            ui.cb.set_model_serving(state, "nope", "int8", "none"),
            ui.cb.set_model_serving(state, mid, "bf16", "none")]
    out.append(ui.cb.model_serving_details(state, mid))
    out.append(state.build_tts_kwargs(state.config.get_model(mid),
                                      state.config.get_voice("builtin-vivian")))
    return out


def sc_download(ui, state, tmp):
    out = [ui.cb.download_model(str(tmp))]
    with patch.dict(sys.modules, {"huggingface_hub": None}):
        out.append(ui.cb.download_model("org/not-cached-model"))
    hub = types.ModuleType("huggingface_hub")
    hub.snapshot_download = MagicMock(side_effect=[None, OSError("offline")])
    with patch.dict(sys.modules, {"huggingface_hub": hub}):
        out.append(ui.cb.download_model("org/not-cached-model"))
        out.append(ui.cb.download_model("org/not-cached-model"))
    out.append([c.args for c in hub.snapshot_download.call_args_list])
    return out


def sc_library(ui, state, tmp):
    wav = tmp / "a.wav"
    wav.write_bytes(b"RIFF")
    state.config.voices.append(ui.cfg.VoiceProfile(id="v1", name="Voice One"))
    for rec in (dict(id="rec1", text="hello world " * 8, voice_id="v1",
                     model_id=_custom(state), output_path=str(wav), timestamp=100.0,
                     duration_sec=1.5),
                dict(id="rec2", text="second item", voice_id="v2", model_id="m-gone",
                     output_path=None, timestamp=200.0, duration_sec=2.0),
                dict(id="rec3", text="third", voice_id="v1", model_id="m-gone",
                     output_path=str(tmp / "missing.wav"), timestamp=150.0)):
        state.add_record(ui.cfg.GenerationRecord(**rec))
    out = [ui.cb.library_model_choices(state), ui.cb.library_voice_choices(state)]
    for search, vf, mf in (("", None, None), ("SECOND", None, None), ("", "v1", None),
                           ("", None, "m-gone"), ("", "v1", "m-gone"), ("zzz", None, None)):
        out.append(ui.cb.library_rows(state, search, vf, mf))
    for rid in ("rec1", "rec2", "rec3", "nope"):
        out += [ui.cb.replay_record(state, rid), ui.cb.library_get_audio(state, rid)]
    out += [ui.cb.delete_record(state, "rec1"), os.path.exists(wav),
            ui.cb.delete_record(state, "nope"), ui.cb.clear_history(state),
            ui.cb.clear_history(state), state.history]
    return out


def sc_training(ui, state, tmp):
    out = [list(ui.cb.train_classifier(state, str(tmp / "missing")))]
    data = tmp / "data"
    data.mkdir()

    def fake_train(dataset_dir, voice_id=None, progress_callback=None, **kw):
        progress_callback("Extracting features...")
        progress_callback("Fitting forest...")
        if voice_id == "bad":
            raise ValueError("need both classes")
        return "/models/x.pkl"

    for voice in ("v1", "bad"):
        with patch(f"{ui.mod}.validation.classifier.trainer.train", side_effect=fake_train) \
                as train, patch(f"{ui.mod}.validation.classifier.clear_cache") as clear:
            out.append(list(ui.cb.train_classifier(state, str(data), voice_id=voice)))
        out.append([train.call_args.args, sorted(train.call_args.kwargs), clear.call_count])
    return out


SCENARIOS = [sc_validation, sc_generate_flow, sc_parameters, sc_phonetics, sc_voices,
             sc_models, sc_serving, sc_download, sc_library, sc_training]


def _normalize(obj, roots):
    text = json.dumps(obj, default=lambda o: getattr(o, "__dict__", repr(o)), sort_keys=True)
    for root in roots:
        text = text.replace(root, "<tmp>")
    return json.loads(text)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__[3:] for s in SCENARIOS])
def test_callbacks_equal_jax(scenario, tmp_path):
    out = {}
    for pkg, ui in UI.items():
        tmp = tmp_path / pkg
        tmp.mkdir()
        counter = itertools.count()
        state = ui.state.AppState(config=ui.cfg.AppConfig(), multi_user=True)
        with patch.object(ui.cfg, "VOICES_DIR", str(tmp / "voices")), \
                patch.object(ui.cfg, "OUTPUTS_DIR", str(tmp / "outputs")), \
                patch.object(uuid, "uuid4", lambda: uuid.UUID(int=next(counter))):
            result = scenario(ui, state, tmp)
        out[pkg] = _normalize([result, state.config.to_dict()], [str(tmp)])
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# generate_audio on the tiny weights, both packages
# ---------------------------------------------------------------------------


def test_generate_audio_on_tiny_weights_matches_jax(fp32_params, jax_prefill_kernel,  # noqa: F811
                                                    tmp_path):
    import jax

    from rho_tts_tpu.models.qwen import PRESETS as JPRESETS
    from rho_tts_tpu.models.qwen.model import QwenTTSModel as JModel
    from rho_tts_tpu.providers.qwen import QwenTTS as JQwenTTS
    from rho_tts_tpu_torch import audio_io, from_jax
    from rho_tts_tpu_torch.models.qwen import PRESETS as TPRESETS
    from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel as TModel
    from rho_tts_tpu_torch.providers.qwen import QwenTTS as TQwenTTS

    jm = JModel(JPRESETS["tiny"], params=fp32_params)
    tp = from_jax.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu")
    models = {"jax": (JQwenTTS, jm), "torch": (TQwenTTS, TModel(TPRESETS["tiny"], params=tp,
                                                                 device="cpu"))}
    wavs, records = {}, {}
    for pkg, ui in UI.items():
        state = ui.state.AppState(config=ui.cfg.AppConfig(), multi_user=True)
        mid = _custom(state)
        state.config.get_model(mid).model_path = "tiny-CustomVoice"
        ui.cb.save_parameters(state, "builtin-aria", mid,
                              {"max_iterations": 1, "seed": 1234, "min_audio_sec": 1.0,
                               "max_chars_per_segment": 200, "device": "cpu"})
        kwargs = state.build_tts_kwargs(state.config.get_model(mid),
                                        state.config.get_voice("builtin-aria"))
        cls, model = models[pkg]
        engine = cls(**kwargs)
        engine._model = model
        with patch.object(state, "get_or_create_tts", return_value=engine):
            updates = list(ui.cb.generate_audio(state, mid, "builtin-aria",
                                                "generated through the web UI",
                                                output_dir=str(tmp_path / pkg)))
        path, status = updates[-1]
        assert status.startswith("✅"), updates
        wavs[pkg] = audio_io.load_wav(path)
        records[pkg] = (state.history[0].text, state.history[0].duration_sec)
    (ours, sr), (ref, ref_sr) = wavs["torch"], wavs["jax"]
    assert sr == ref_sr and ours.shape == ref.shape and ours.size > 0
    np.testing.assert_allclose(ours, ref, atol=1e-4 + LSB, rtol=0)
    assert records["torch"] == records["jax"]
    assert isinstance(torch.from_numpy(ours), torch.Tensor)


from test_torch_port_slice import fp32_params, jax_prefill_kernel  # noqa: E402,F401 — fixtures
