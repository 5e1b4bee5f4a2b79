"""Gradio Blocks web UI: Generate / Voices / Models / Training / Library.

Multi-user mode (auto-detected via the ``SPACE_ID`` env var, or forced
with ``--multi-user``) gives every browser tab an isolated
:class:`SessionContext`; single-user mode persists config/history to disk.

Counterpart of ``rho_tts_tpu/ui/app.py``: the same five tabs and event
wiring, on the port's callbacks. gradio is imported only inside
:func:`_build_app`, so everything else imports without it.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

from . import callbacks as cb
from .config import AppConfig, load_config
from .session import SessionContext
from .state import AppState

logger = logging.getLogger(__name__)

_FORMATS = ["wav", "mp3", "flac", "ogg"]


def _build_app(multi_user: bool = False):
    import gradio as gr

    base_config: Optional[AppConfig] = load_config() if multi_user else None

    def new_session():
        if multi_user:
            return SessionContext(base_config)
        ctx = SessionContext.__new__(SessionContext)
        ctx.state = AppState()
        ctx._output_dir = None
        return ctx

    with gr.Blocks(title="rho-tts-tpu") as app:
        session = gr.State(value=new_session, delete_callback=lambda s: s.cleanup() if multi_user else None)

        gr.Markdown("# rho-tts-tpu — text-to-speech on the GPU")

        # ------------------------------------------------------------------
        # Tab 1: Generate
        # ------------------------------------------------------------------
        with gr.Tab("Generate"):
            with gr.Row():
                model_dd = gr.Dropdown(label="Model", choices=[], interactive=True)
                voice_dd = gr.Dropdown(label="Voice", choices=[], interactive=True)
            text_in = gr.Textbox(label="Text", lines=5, placeholder="Enter text to synthesize…")
            with gr.Row():
                fmt_dd = gr.Dropdown(label="Format", choices=_FORMATS, value="wav")
                speed_sl = gr.Slider(0.5, 2.0, value=1.0, step=0.05, label="Speed")
                pitch_sl = gr.Slider(-12, 12, value=0.0, step=0.5, label="Pitch (semitones)")
            with gr.Accordion("Pronunciation (phonetic mapping)", open=False):
                phon_df = gr.Dataframe(
                    headers=["word", "pronounce as"], datatype=["str", "str"],
                    row_count=(1, "dynamic"), col_count=(2, "fixed"),
                )
                phon_save_btn = gr.Button("Save pronunciations")
            with gr.Accordion("Generation parameters", open=False):
                max_iter_sl = gr.Slider(1, 50, value=10, step=1, label="Max validation retries")
                drift_sl = gr.Slider(0.01, 1.0, value=0.17, step=0.01, label="Accent drift threshold")
                sim_sl = gr.Slider(0.1, 1.0, value=0.85, step=0.01, label="Text similarity threshold")
                with gr.Row():
                    seed_tb = gr.Textbox(label="Seed", value="789")
                    temp_sl = gr.Slider(0.1, 2.0, value=1.0, step=0.05, label="Temperature (Chatterbox)")
                    cfgw_sl = gr.Slider(0.0, 1.0, value=0.6, step=0.05, label="CFG weight (Chatterbox)")
                param_save_btn = gr.Button("Save parameters")
                param_status = gr.Markdown("")
            with gr.Row():
                gen_btn = gr.Button("Generate", variant="primary")
                cancel_btn = gr.Button("Cancel")
            status_md = gr.Markdown("")
            audio_out = gr.Audio(label="Output", interactive=False)

            def model_choices(ctx):
                return [(m.label, m.id) for m in ctx.state.config.models]

            def refresh_generate_tab(ctx):
                models = model_choices(ctx)
                model_id = ctx.state.config.last_model_id or (models[0][1] if models else None)
                voices = cb.voice_choices_for_model(ctx.state, model_id) if model_id else []
                voice_id = ctx.state.config.last_voice_id
                if voice_id not in [v for _, v in voices]:
                    voice_id = voices[0][1] if voices else None
                return (
                    gr.update(choices=models, value=model_id),
                    gr.update(choices=voices, value=voice_id),
                )

            def on_model_change(ctx, model_id):
                voices = cb.voice_choices_for_model(ctx.state, model_id)
                return gr.update(choices=voices, value=voices[0][1] if voices else None)

            def on_pair_change(ctx, voice_id, model_id):
                if not voice_id or not model_id:
                    return [], 10, 0.17, 0.85, "789", 1.0, 0.6
                rows = cb.load_phonetic_rows(ctx.state, voice_id, model_id)
                params = cb.load_parameters(ctx.state, voice_id, model_id)
                return (
                    rows or [["", ""]],
                    params.get("max_iterations", 10),
                    params.get("accent_drift_threshold", 0.17),
                    params.get("text_similarity_threshold", 0.85),
                    str(params.get("seed", 789)),
                    params.get("temperature", 1.0),
                    params.get("cfg_weight", 0.6),
                )

            def do_generate(ctx, model_id, voice_id, text, fmt, speed, pitch):
                out_dir = ctx.output_dir if multi_user else None
                for path, status in cb.generate_audio(
                    ctx.state, model_id, voice_id, text, fmt, speed, pitch, output_dir=out_dir
                ):
                    yield path, status

            def do_cancel(ctx):
                return cb.cancel_generation(ctx.state)

            def do_save_params(ctx, voice_id, model_id, max_iter, drift, sim, seed, temp, cfgw):
                if not voice_id or not model_id:
                    return "❌ Pick a voice and model first."
                params = {
                    "max_iterations": int(max_iter),
                    "accent_drift_threshold": float(drift),
                    "text_similarity_threshold": float(sim),
                    # provider-specific keys are filtered in build_tts_kwargs
                    "temperature": float(temp),
                    "cfg_weight": float(cfgw),
                }
                seed_warn = ""
                raw_seed = "" if seed is None else str(seed).strip()
                if raw_seed:
                    try:
                        params["seed"] = int(raw_seed)
                    except (TypeError, ValueError):
                        seed_warn = " ⚠️ seed must be an integer — seed not saved"
                return cb.save_parameters(ctx.state, voice_id, model_id, params) + seed_warn

            def do_save_phonetics(ctx, voice_id, model_id, rows):
                if not voice_id or not model_id:
                    return "❌ Pick a voice and model first."
                data = rows.values.tolist() if hasattr(rows, "values") else rows
                return cb.save_phonetic_rows(ctx.state, voice_id, model_id, data)

            model_dd.change(on_model_change, [session, model_dd], [voice_dd])
            voice_dd.change(
                on_pair_change, [session, voice_dd, model_dd],
                [phon_df, max_iter_sl, drift_sl, sim_sl, seed_tb, temp_sl, cfgw_sl],
            )
            gen_btn.click(
                do_generate,
                [session, model_dd, voice_dd, text_in, fmt_dd, speed_sl, pitch_sl],
                [audio_out, status_md],
                concurrency_limit=1,
            )
            cancel_btn.click(do_cancel, [session], [status_md])
            param_save_btn.click(
                do_save_params,
                [session, voice_dd, model_dd, max_iter_sl, drift_sl, sim_sl, seed_tb, temp_sl, cfgw_sl],
                [param_status],
            )
            phon_save_btn.click(
                do_save_phonetics, [session, voice_dd, model_dd, phon_df], [param_status]
            )

        # ------------------------------------------------------------------
        # Tab 2: Voices
        # ------------------------------------------------------------------
        with gr.Tab("Voices"):
            voices_df = gr.Dataframe(
                headers=["id", "name", "provider", "type", "language"],
                interactive=False,
            )
            with gr.Row():
                v_name = gr.Textbox(label="Name")
                v_provider = gr.Dropdown(
                    label="Provider", choices=["qwen", "chatterbox"], value="qwen"
                )
                v_language = gr.Dropdown(
                    label="Language",
                    choices=["English", "Chinese", "Japanese", "Korean"],
                    value="English",
                )
            v_ref_audio = gr.Audio(label="Reference audio (for cloning)", type="filepath")
            v_ref_text = gr.Textbox(label="Reference transcript", lines=2)
            with gr.Row():
                v_add_btn = gr.Button("Add voice", variant="primary")
                v_del_id = gr.Textbox(label="Voice id to delete")
                v_del_btn = gr.Button("Delete voice")
            v_status = gr.Markdown("")

            def voices_table(ctx):
                return [
                    [
                        v.id,
                        v.name,
                        v.provider,
                        "cloning" if v.is_cloning else (v.speaker or "default"),
                        v.language,
                    ]
                    for v in ctx.state.config.voices
                ]

            def do_add_voice(ctx, name, provider, language, ref_audio, ref_text):
                _voice, msg = cb.add_voice(
                    ctx.state, name, provider,
                    reference_audio=ref_audio, reference_text=ref_text,
                    language=language,
                )
                return voices_table(ctx), msg

            def do_del_voice(ctx, voice_id):
                msg = cb.delete_voice(ctx.state, voice_id)
                return voices_table(ctx), msg

            v_add_btn.click(
                do_add_voice,
                [session, v_name, v_provider, v_language, v_ref_audio, v_ref_text],
                [voices_df, v_status],
            )
            v_del_btn.click(do_del_voice, [session, v_del_id], [voices_df, v_status])

            with gr.Accordion("Edit voice", open=False):
                ev_id = gr.Textbox(label="Voice id")
                ev_load_btn = gr.Button("Load")
                with gr.Row():
                    ev_name = gr.Textbox(label="New name")
                    ev_language = gr.Dropdown(
                        label="Language",
                        choices=["English", "Chinese", "Japanese", "Korean"],
                    )
                ev_ref_text = gr.Textbox(label="Reference transcript", lines=2)
                ev_save_btn = gr.Button("Save changes", variant="primary")
                ev_status = gr.Markdown("")

            def do_load_voice(ctx, voice_id):
                d = cb.voice_details(ctx.state, voice_id)
                if not d:
                    return gr.update(), gr.update(), gr.update(), "❌ Voice not found."
                note = "ℹ️ Built-in voices are read-only." if d["is_builtin"] else ""
                return d["name"], d["language"], d["reference_text"], note

            def do_edit_voice(ctx, voice_id, name, language, ref_text):
                msg = cb.edit_voice(ctx.state, voice_id, name, language, ref_text)
                return voices_table(ctx), msg

            ev_load_btn.click(
                do_load_voice, [session, ev_id],
                [ev_name, ev_language, ev_ref_text, ev_status],
            )
            ev_save_btn.click(
                do_edit_voice, [session, ev_id, ev_name, ev_language, ev_ref_text],
                [voices_df, ev_status],
            )

        # ------------------------------------------------------------------
        # Tab 3: Models
        # ------------------------------------------------------------------
        with gr.Tab("Models"):
            models_df = gr.Dataframe(
                headers=["id", "label", "provider", "path", "cached"], interactive=False
            )
            with gr.Row():
                m_label = gr.Textbox(label="Label")
                m_provider = gr.Dropdown(
                    label="Provider", choices=["qwen", "chatterbox"], value="qwen"
                )
                m_path = gr.Textbox(label="Model path / HF id")
                m_needs_ref = gr.Checkbox(label="Needs reference audio (Base/cloning)")
            with gr.Row():
                m_add_btn = gr.Button("Add model", variant="primary")
                m_dl_btn = gr.Button("Download to cache")
                m_del_id = gr.Textbox(label="Model id to delete")
                m_del_btn = gr.Button("Delete model")
            m_status = gr.Markdown("")

            def models_table(ctx):
                from .config import is_model_cached

                return [
                    [m.id, m.label, m.provider, m.model_path,
                     "✓" if is_model_cached(m.model_path) else "—"]
                    for m in ctx.state.config.models
                ]

            def do_add_model(ctx, label, provider, path, needs_ref):
                _m, msg = cb.add_model(ctx.state, label, provider, path, needs_ref)
                return models_table(ctx), msg

            def do_del_model(ctx, model_id):
                msg = cb.delete_model(ctx.state, model_id)
                return models_table(ctx), msg

            def do_download(ctx, path):
                return models_table(ctx), cb.download_model(path)

            m_add_btn.click(
                do_add_model, [session, m_label, m_provider, m_path, m_needs_ref],
                [models_df, m_status],
            )
            m_del_btn.click(do_del_model, [session, m_del_id], [models_df, m_status])
            m_dl_btn.click(do_download, [session, m_path], [models_df, m_status])

            with gr.Accordion("Add from catalog", open=False):
                with gr.Row():
                    cat_provider = gr.Dropdown(
                        label="Provider", choices=["qwen", "chatterbox"], value="qwen"
                    )
                    cat_model = gr.Dropdown(
                        label="Catalog model", choices=cb.catalog_choices("qwen")
                    )
                with gr.Row():
                    cat_iters = gr.Slider(1, 50, value=10, step=1, label="Max retries")
                    cat_drift = gr.Slider(0.01, 1.0, value=0.17, step=0.01, label="Drift threshold")
                    cat_sim = gr.Slider(0.1, 1.0, value=0.85, step=0.01, label="Text similarity")
                cat_add_btn = gr.Button("Add from catalog", variant="primary")
                cat_status = gr.Markdown("")

            def on_cat_provider(provider):
                choices = cb.catalog_choices(provider)
                return gr.update(choices=choices, value=choices[0][1] if choices else None)

            def on_cat_model(provider, entry_id):
                e = cb.catalog_entry(provider, entry_id)
                if e is None:
                    return gr.update(), gr.update(), gr.update()
                p = e.get("default_params", {})
                return (
                    p.get("max_iterations", 10),
                    p.get("accent_drift_threshold", 0.17),
                    p.get("text_similarity_threshold", 0.85),
                )

            def do_cat_add(ctx, provider, entry_id, iters, drift, sim):
                _m, msg = cb.add_model_from_catalog(
                    ctx.state, provider, entry_id,
                    max_iterations=iters,
                    accent_drift_threshold=drift,
                    text_similarity_threshold=sim,
                )
                return models_table(ctx), msg

            cat_provider.change(on_cat_provider, [cat_provider], [cat_model])
            cat_model.change(
                on_cat_model, [cat_provider, cat_model], [cat_iters, cat_drift, cat_sim]
            )
            cat_add_btn.click(
                do_cat_add,
                [session, cat_provider, cat_model, cat_iters, cat_drift, cat_sim],
                [models_df, cat_status],
            )

            with gr.Accordion("Edit model", open=False):
                em_id = gr.Textbox(label="Model id")
                em_load_btn = gr.Button("Load")
                em_label = gr.Textbox(label="Label")
                with gr.Row():
                    em_iters = gr.Slider(1, 50, value=10, step=1, label="Max retries")
                    em_drift = gr.Slider(0.01, 1.0, value=0.17, step=0.01, label="Drift threshold")
                    em_sim = gr.Slider(0.1, 1.0, value=0.85, step=0.01, label="Text similarity")
                em_save_btn = gr.Button("Save changes", variant="primary")
                em_status = gr.Markdown("")

            def do_load_model(ctx, model_id):
                d = cb.model_details(ctx.state, model_id)
                if not d:
                    return gr.update(), gr.update(), gr.update(), gr.update(), "❌ Model not found."
                return (
                    d["label"], d["max_iterations"], d["accent_drift_threshold"],
                    d["text_similarity_threshold"], "",
                )

            def do_edit_model(ctx, model_id, label, iters, drift, sim):
                msg = cb.edit_model(ctx.state, model_id, label, iters, drift, sim)
                return models_table(ctx), msg

            em_load_btn.click(
                do_load_model, [session, em_id],
                [em_label, em_iters, em_drift, em_sim, em_status],
            )
            em_save_btn.click(
                do_edit_model,
                [session, em_id, em_label, em_iters, em_drift, em_sim],
                [models_df, em_status],
            )

            with gr.Accordion("GPU serving", open=False):
                # Precision + mesh layout + speculative draft + LoRA +
                # continuous batching, persisted per model.
                sv_id = gr.Textbox(label="Model id")
                sv_load_btn = gr.Button("Load")
                with gr.Row():
                    sv_quant = gr.Dropdown(
                        label="Quantization", choices=["bf16", "int8", "int4"],
                        value="int8",
                    )
                    sv_parallel = gr.Dropdown(
                        label="Parallelism", choices=["none", "data", "tensor"],
                        value="none",
                    )
                with gr.Row():
                    sv_draft = gr.Textbox(
                        label="Draft model path (speculative decoding; empty = off)"
                    )
                    sv_gamma = gr.Slider(
                        1, 8, value=4, step=1, label="Speculative γ (tokens/round)"
                    )
                sv_lora = gr.Textbox(
                    label="LoRA adapter path (per-voice adaptation; empty = off)"
                )
                sv_serving = gr.Checkbox(
                    label="Continuous batching (segments share a serving "
                    "slot batch; retries rejoin immediately)",
                    value=False,
                )
                sv_save_btn = gr.Button("Save serving config", variant="primary")
                sv_status = gr.Markdown("")

            def do_load_serving(ctx, model_id):
                d = cb.model_serving_details(ctx.state, model_id)
                if not d:
                    return (
                        gr.update(), gr.update(), gr.update(), gr.update(),
                        gr.update(), gr.update(), "❌ Model not found.",
                    )
                return (
                    d["quantization"], d["parallelism"], d["draft_model_path"],
                    d["speculative_gamma"], d["lora_path"], d["serving"], "",
                )

            def do_save_serving(ctx, model_id, quant, parallel, draft, gamma, lora, serving):
                return cb.set_model_serving(
                    ctx.state, model_id, quant, parallel, draft, int(gamma),
                    lora, bool(serving),
                )

            sv_load_btn.click(
                do_load_serving, [session, sv_id],
                [sv_quant, sv_parallel, sv_draft, sv_gamma, sv_lora,
                 sv_serving, sv_status],
            )
            sv_save_btn.click(
                do_save_serving,
                [session, sv_id, sv_quant, sv_parallel, sv_draft, sv_gamma,
                 sv_lora, sv_serving],
                [sv_status],
            )

        # ------------------------------------------------------------------
        # Tab 4: Training
        # ------------------------------------------------------------------
        with gr.Tab("Training"):
            if multi_user:
                gr.Markdown("⚠️ Classifier training is disabled in multi-user mode.")
            else:
                t_dataset = gr.Textbox(
                    label="Dataset directory (contains good/ and bad/ wav folders)"
                )
                t_voice = gr.Textbox(label="Voice id (optional, for a per-voice model)")
                t_btn = gr.Button("Train drift classifier", variant="primary")
                t_log = gr.Textbox(label="Training log", lines=14, interactive=False)

                def do_train(ctx, dataset_dir, voice_id):
                    for line in cb.train_classifier(
                        ctx.state, dataset_dir, voice_id or None
                    ):
                        yield line

                t_btn.click(do_train, [session, t_dataset, t_voice], [t_log])

        # ------------------------------------------------------------------
        # Tab 5: Library
        # ------------------------------------------------------------------
        with gr.Tab("Library"):
            # Library: search, filters, playback, re-generate, delete
            # (src/rho_tts/ui/app.py:725-865): model/voice filter dropdowns,
            # text search, table-row selection (no typed record id),
            # playback + full-transcript pane, Re-generate, Delete, Clear All.
            with gr.Row():
                lib_model_dd = gr.Dropdown(
                    label="Filter by Model", choices=[], interactive=True
                )
                lib_voice_dd = gr.Dropdown(
                    label="Filter by Voice", choices=[], interactive=True
                )
                lib_search = gr.Textbox(label="Search text")
                lib_refresh = gr.Button("Apply Filters")
            lib_df = gr.Dataframe(
                headers=["id", "when", "text", "voice", "model", "duration"],
                interactive=False,
            )
            with gr.Row():
                lib_audio = gr.Audio(label="Playback", interactive=False)
                lib_transcript = gr.Textbox(
                    label="Full Transcript", lines=4, interactive=False
                )
            with gr.Row():
                lib_regen_btn = gr.Button("Re-generate")
                lib_del_btn = gr.Button("Delete Selected", variant="stop")
                lib_clear_btn = gr.Button("Clear All History", variant="stop")
                lib_status = gr.Markdown("")
            lib_selected = gr.State(value=None)

            def do_library(ctx, search, voice_f, model_f):
                return cb.library_rows(
                    ctx.state, search, voice_f or None, model_f or None
                )

            def lib_filter_choices(ctx):
                return (
                    gr.Dropdown(choices=cb.library_model_choices(ctx.state)),
                    gr.Dropdown(choices=cb.library_voice_choices(ctx.state)),
                )

            def do_select(ctx, rows, evt: gr.SelectData):
                data = rows.values.tolist() if hasattr(rows, "values") else rows
                idx = evt.index[0] if isinstance(evt.index, (list, tuple)) else evt.index
                if not data or idx is None or idx < 0 or idx >= len(data):
                    return None, "", None
                record_id = data[idx][0]  # id is the first column
                path, text = cb.library_get_audio(ctx.state, record_id)
                return path, text, record_id

            def do_del_record(ctx, record_id, search, voice_f, model_f):
                if not record_id:
                    msg = "❌ Select a row first."
                else:
                    msg = cb.delete_record(ctx.state, record_id)
                table = do_library(ctx, search, voice_f, model_f)
                m_dd, v_dd = lib_filter_choices(ctx)
                return table, msg, None, None, "", m_dd, v_dd

            def do_clear_history(ctx, search, voice_f, model_f):
                msg = cb.clear_history(ctx.state)
                m_dd, v_dd = lib_filter_choices(ctx)
                return [], msg, None, None, "", m_dd, v_dd

            def do_regenerate(ctx, record_id):
                """Load the selected record into the Generate tab."""
                if not record_id:
                    return gr.skip(), gr.skip(), gr.skip(), "❌ Select a row first."
                record = ctx.state.get_record(record_id)
                if record is None:
                    return gr.skip(), gr.skip(), gr.skip(), "❌ Record not found."
                if ctx.state.config.get_model(record.model_id) is None:
                    return (
                        gr.skip(), gr.skip(), gr.skip(),
                        "❌ That record's model no longer exists.",
                    )
                return (
                    gr.Dropdown(value=record.model_id),
                    gr.Dropdown(value=record.voice_id),
                    record.text,
                    "✅ Loaded into the Generate tab.",
                )

            lib_refresh.click(
                do_library, [session, lib_search, lib_voice_dd, lib_model_dd], [lib_df]
            )
            lib_df.select(
                do_select, [session, lib_df], [lib_audio, lib_transcript, lib_selected]
            )
            lib_del_btn.click(
                do_del_record,
                [session, lib_selected, lib_search, lib_voice_dd, lib_model_dd],
                [lib_df, lib_status, lib_selected, lib_audio, lib_transcript,
                 lib_model_dd, lib_voice_dd],
            )
            lib_clear_btn.click(
                do_clear_history,
                [session, lib_search, lib_voice_dd, lib_model_dd],
                [lib_df, lib_status, lib_selected, lib_audio, lib_transcript,
                 lib_model_dd, lib_voice_dd],
            )
            lib_regen_btn.click(
                do_regenerate,
                [session, lib_selected],
                [model_dd, voice_dd, text_in, lib_status],
            )

        # Hydrate dropdowns when the app loads
        app.load(refresh_generate_tab, [session], [model_dd, voice_dd])
        app.load(lib_filter_choices, [session], [lib_model_dd, lib_voice_dd])

    return app


def launch_ui(
    host: Optional[str] = None,
    port: Optional[int] = None,
    share: bool = False,
    multi_user: Optional[bool] = None,
):
    """Build and launch the web UI (blocking)."""
    parser = argparse.ArgumentParser(description="rho-tts-tpu web UI")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--share", action="store_true")
    parser.add_argument("--multi-user", action="store_true")
    args, _ = parser.parse_known_args()

    if multi_user is None:
        multi_user = args.multi_user or bool(os.environ.get("SPACE_ID"))

    app = _build_app(multi_user=multi_user)
    app.queue().launch(
        server_name=host or args.host or os.environ.get("GRADIO_SERVER_NAME", "127.0.0.1"),
        server_port=port or args.port,
        share=share or args.share,
    )
