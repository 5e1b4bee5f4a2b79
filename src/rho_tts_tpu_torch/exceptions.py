"""Exception hierarchy of the PyTorch port (its own copy of the JAX package's).

Every library error derives from :class:`RhoTTSError` so callers can catch
the whole family with a single ``except`` clause. Each exception carries an
optional machine-readable ``code``, the same codes as the JAX package's
``rho_tts_tpu.exceptions``.
"""

from __future__ import annotations


class RhoTTSError(Exception):
    """Base class for all rho-tts-tpu errors."""

    code = "error"

    def __init__(self, message: str = "", *, details: dict | None = None):
        super().__init__(message)
        self.details = details or {}


class ProviderNotFoundError(RhoTTSError):
    """The requested TTS provider is not registered with the factory."""

    code = "provider_not_found"


class ModelLoadError(RhoTTSError):
    """Model weights, config, or device placement failed to load."""

    code = "model_load"


class AudioGenerationError(RhoTTSError):
    """The synthesis path failed to produce audio."""

    code = "audio_generation"


class FormatConversionError(RhoTTSError):
    """Audio format conversion failed or the format is unsupported."""

    code = "format_conversion"


#: code → class, for rebuilding typed errors from their wire form.
ERROR_CODES = {
    cls.code: cls
    for cls in (
        RhoTTSError,
        ProviderNotFoundError,
        ModelLoadError,
        AudioGenerationError,
        FormatConversionError,
    )
}


def from_code(code: str, message: str) -> RhoTTSError:
    """Rebuild a typed error from its wire representation."""
    return ERROR_CODES.get(code, RhoTTSError)(message)
