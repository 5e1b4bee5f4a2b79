"""Per-provider virtual environments, created lazily and cached.

Layout: ``~/.rho_tts_tpu_torch/venvs/<provider>/`` with a marker file recording
a hash of the package source — pyproject.toml for editable installs (so a
dependency edit triggers exactly one reinstall) or the release version
otherwise. The module-level helpers (:func:`source_hash`,
:func:`find_project_root`, :func:`pip_install`) are separable so tests can
exercise them without touching real venvs.

Counterpart of ``rho_tts_tpu/isolation/venvs.py``. Its own root and marker
name, so the two packages never share a venv or its marker; both providers
install the distribution's ``torch`` extra (PyTorch), where the JAX
package's ``qwen`` / ``chatterbox`` extras install none.
"""

from __future__ import annotations

import hashlib
import logging
import subprocess
import sys
import venv
from pathlib import Path
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

#: provider name → extras key in pyproject.toml
PROVIDER_EXTRAS: Dict[str, str] = {
    "qwen": "torch",
    "chatterbox": "torch",
}

VENVS_ROOT = Path.home() / ".rho_tts_tpu_torch" / "venvs"
MARKER_FILE = ".rho_tts_tpu_torch_installed"
INSTALL_TIMEOUT_SEC = 600


def source_hash() -> str:
    """Short hash identifying the current package source / version."""
    try:
        pyproject = Path(__file__).resolve().parents[3] / "pyproject.toml"
        if pyproject.exists():
            return hashlib.sha256(pyproject.read_bytes()).hexdigest()[:16]
    except Exception:  # noqa: BLE001
        pass
    try:
        from rho_tts_tpu_torch import __version__

        return hashlib.sha256(__version__.encode()).hexdigest()[:16]
    except Exception:  # noqa: BLE001
        return "unknown"


def find_project_root() -> Optional[Path]:
    """Nearest ancestor directory containing a pyproject.toml (≤ 6 levels)."""
    current = Path(__file__).resolve().parent
    for _ in range(6):
        if (current / "pyproject.toml").exists():
            return current
        current = current.parent
    return None


def pip_install(python: str, extras_key: str) -> None:
    """Install this package (+extras) into the interpreter's environment.

    Editable install when running from a source tree, PyPI otherwise.

    Raises:
        RuntimeError: when pip exits nonzero (stderr tail included).
    """
    root = find_project_root()
    if root is not None:
        spec: List[str] = ["-e", f"{root}[{extras_key}]"]
        human = f"-e {root}[{extras_key}]"
    else:
        spec = [f"rho-tts-tpu[{extras_key}]"]
        human = spec[0]

    cmd = [python, "-m", "pip", "install", *spec]
    logger.info("Installing %s (this may take a few minutes)...", human)
    result = subprocess.run(
        cmd, capture_output=True, text=True, timeout=INSTALL_TIMEOUT_SEC
    )
    if result.returncode != 0:
        logger.error("pip install failed:\n%s", result.stderr)
        raise RuntimeError(
            f"Failed to install dependencies ({human}).\n"
            f"Command: {' '.join(cmd)}\nstderr: {result.stderr[-500:]}"
        )
    logger.info("Installation complete (%s)", human)


class VenvManager:
    """One isolated venv per provider, built on the helpers above."""

    def __init__(self, provider: str, venvs_root: Optional[Path] = None):
        if provider not in PROVIDER_EXTRAS:
            raise ValueError(
                f"Unknown provider '{provider}'. Supported: {', '.join(PROVIDER_EXTRAS)}"
            )
        self.provider = provider
        self.extras_key = PROVIDER_EXTRAS[provider]
        self.venv_dir = (venvs_root or VENVS_ROOT) / provider

    @property
    def python(self) -> str:
        """The venv's interpreter path (platform-aware)."""
        sub = ("Scripts", "python.exe") if sys.platform == "win32" else ("bin", "python")
        return str(self.venv_dir.joinpath(*sub))

    @property
    def marker(self) -> Path:
        return self.venv_dir / MARKER_FILE

    def is_current(self) -> bool:
        """True when the installed marker matches the current source hash."""
        return self.marker.exists() and self.marker.read_text().strip() == source_hash()

    def ensure_venv(self) -> str:
        """Create + install if stale; return the interpreter path."""
        if self.is_current():
            logger.debug("Venv for '%s' is up to date", self.provider)
            return self.python

        logger.info(
            "Setting up isolated environment for '%s' (one-time)...", self.provider
        )
        if not self.venv_dir.exists() or not Path(self.python).exists():
            self.venv_dir.mkdir(parents=True, exist_ok=True)
            venv.create(str(self.venv_dir), with_pip=True, clear=True)

        pip_install(self.python, self.extras_key)
        self.marker.write_text(source_hash())
        logger.info("Isolated environment for '%s' ready", self.provider)
        return self.python
