"""Port parity of the web UI's layout: ``ui.app._build_app`` under a fake gradio.

gradio is on neither the development host nor the GPU machine, so the
recording fake ``gradio`` of ``tests/test_ui_app.py`` stands in for it: it
records each component's construction and event wiring. The port's app
builds the same five tabs with the same components and the same event
wiring as the JAX package's (handler names, event kinds, input and output
component types), says "GPU" where the JAX app says "TPU", and its
load-time hydration runs against a real session.
"""

import sys

import pytest

from test_ui_app import _Blocks, _Component, _make_fake_gradio


@pytest.fixture()
def fake_gradio(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "gradio", _make_fake_gradio())
    monkeypatch.setenv("RHO_TTS_TPU_CONFIG", str(tmp_path / "config.json"))
    monkeypatch.setenv("RHO_TTS_TPU_HISTORY", str(tmp_path / "history.json"))
    yield sys.modules["gradio"]


def _describe(comp):
    return (type(comp).__name__, comp.kwargs.get("label"))


def _build(pkg, multi_user):
    """Build one package's app; return it and its components' wiring."""
    import importlib

    _Component._registry.clear()
    app = importlib.import_module(f"{pkg}.ui.app")._build_app(multi_user=multi_user)
    comps = list(_Component._registry)
    wiring = [(_describe(c), kind, fn.__name__, [_describe(i) for i in (inputs or [])],
               [_describe(o) for o in (outputs or [])])
              for c in comps for kind, fn, inputs, outputs in c.events]
    texts = [c.args[0] for c in comps if type(c).__name__ == "Markdown" and c.args]
    labels = [_describe(c) for c in comps]
    return app, wiring, texts, labels


@pytest.mark.parametrize("multi_user", [False, True])
def test_app_matches_jax_layout_and_wiring(fake_gradio, multi_user):
    ref, ref_wiring, ref_texts, ref_labels = _build("rho_tts_tpu", multi_user)
    app, wiring, texts, labels = _build("rho_tts_tpu_torch", multi_user)
    assert isinstance(app, _Blocks)
    assert app.tabs == ref.tabs == ["Generate", "Voices", "Models", "Training", "Library"]
    assert len(app.load_events) == len(ref.load_events) == 2
    assert [(fn.__name__, [_describe(i) for i in ins], [_describe(o) for o in outs])
            for fn, ins, outs in app.load_events] == \
        [(fn.__name__, [_describe(i) for i in ins], [_describe(o) for o in outs])
         for fn, ins, outs in ref.load_events]
    assert wiring == ref_wiring and len(wiring) >= 20
    # the same components, but for the serving accordion's name
    assert [lab for lab in labels if lab != ("Accordion", None)] == \
        [lab for lab in ref_labels if lab != ("Accordion", None)]
    accordions = [c.args[0] for c in _Component._registry if type(c).__name__ == "Accordion"]
    assert "GPU serving" in accordions and "TPU serving" not in accordions
    assert any("GPU" in t for t in texts) and not any("TPU" in t for t in texts)
    assert any("TPU" in t for t in ref_texts)


@pytest.mark.parametrize("last_model", [None, "qwen-1.7b-custom"])
def test_load_time_hydration_equals_jax(fake_gradio, last_model):
    out = {}
    for pkg in ("rho_tts_tpu", "rho_tts_tpu_torch"):
        app, *_ = _build(pkg, multi_user=True)
        fn, inputs, outputs = app.load_events[0]
        ctx = inputs[0].kwargs["value"]()
        ctx.state.config.last_model_id = last_model
        model_upd, voice_upd = fn(ctx)
        m_dd, v_dd = app.load_events[1][0](ctx)
        out[pkg] = (model_upd, voice_upd, m_dd.kwargs, v_dd.kwargs)
        ctx.cleanup()
    assert out["rho_tts_tpu_torch"] == out["rho_tts_tpu"]
    model_upd, voice_upd, m_dd, _ = out["rho_tts_tpu_torch"]
    assert model_upd["choices"] and m_dd["choices"][0] == ("All models", "")
    if last_model:  # a CustomVoice model offers the named speakers
        assert model_upd["value"] == last_model and voice_upd["value"] == "builtin-chelsie"


def test_multi_user_sessions_are_isolated(fake_gradio):
    from rho_tts_tpu_torch.ui.app import _build_app
    from rho_tts_tpu_torch.ui.session import SessionContext

    app = _build_app(multi_user=True)
    factory = app.load_events[0][1][0].kwargs["value"]
    a, b = factory(), factory()
    assert isinstance(a, SessionContext) and a is not b and a.state is not b.state
    assert a.state.multi_user and a.state.config is not b.state.config
    a.cleanup()
    b.cleanup()


def test_launch_ui_builds_and_launches(fake_gradio, monkeypatch):
    from rho_tts_tpu_torch.ui import app as app_mod

    monkeypatch.setattr(sys, "argv", ["rho-tts-tpu-torch-ui", "--port", "7861"])
    app_mod.launch_ui(host="0.0.0.0")
    launched = _Blocks._last.launched
    assert launched == {"server_name": "0.0.0.0", "server_port": 7861, "share": False}


def test_app_imports_gradio_only_to_build(monkeypatch):
    """Everything but ``_build_app`` imports and runs without gradio."""
    monkeypatch.setitem(sys.modules, "gradio", None)
    import rho_tts_tpu_torch.ui as ui
    from rho_tts_tpu_torch.ui import app as app_mod

    assert callable(ui.main) and callable(app_mod.launch_ui)
    with pytest.raises(ImportError):
        app_mod._build_app()
