"""Per-browser-tab session isolation for multi-user deployments.

Each session gets its own deep-copied config, in-memory history,
cancellation token, and a lazily created temp output directory — so
concurrent users (e.g. a shared Space) can't see or clobber each other's
voices, overrides, or files.

Counterpart of ``rho_tts_tpu/ui/session.py``.
"""

from __future__ import annotations

import copy
import logging
import shutil
import tempfile
from typing import Optional

from .config import AppConfig, load_config
from .state import AppState

logger = logging.getLogger(__name__)


class SessionContext:
    """Isolated state for one browser session."""

    def __init__(self, base_config: Optional[AppConfig] = None):
        config = copy.deepcopy(base_config) if base_config is not None else load_config()
        self.state = AppState(config=config, multi_user=True)
        self._output_dir: Optional[str] = None

    @property
    def output_dir(self) -> str:
        """Lazily created per-session temp directory for generated audio."""
        if self._output_dir is None:
            self._output_dir = tempfile.mkdtemp(prefix="rho_tts_tpu_torch_session_")
        return self._output_dir

    def cleanup(self) -> None:
        """Tear down the TTS instance and remove the temp dir. Idempotent."""
        try:
            self.state.invalidate_tts()
        except Exception:  # noqa: BLE001
            pass
        if self._output_dir is not None:
            shutil.rmtree(self._output_dir, ignore_errors=True)
            self._output_dir = None
