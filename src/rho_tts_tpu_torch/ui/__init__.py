"""Web UI (Gradio) for interactive generation, voice/model management,
classifier training, and a generation library.

Requires the ``ui`` extra (gradio). Everything except ``app`` is plain
Python and testable without gradio. Console script:
``rho-tts-tpu-torch-ui``; or ``python -m rho_tts_tpu_torch.ui``.
"""


def launch_ui(**kwargs):
    from .app import launch_ui as _launch

    _launch(**kwargs)


def main():  # console-script entry point
    launch_ui()
