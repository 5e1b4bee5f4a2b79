"""Static provider/voice capability metadata.

These records answer "what can this provider do, which voices does it ship"
without touching any model weights. The port's own copy of
``rho_tts_tpu.provider_info``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["ProviderInfo", "VoiceInfo"]


@dataclass
class VoiceInfo:
    """One selectable voice.

    ``id`` is the stable key used in API calls and UI persistence; ``name``
    is the human label.  ``is_builtin`` distinguishes provider-shipped
    speakers from user-created clone voices.
    """

    id: str
    name: str
    language: str = "English"
    is_builtin: bool = True


@dataclass
class ProviderInfo:
    """Capability summary for one registered provider.

    ``builtin_voices`` lists the named speakers available without cloning
    (empty for clone-only model families); ``supported_languages`` is
    advisory — providers accept any text and this drives UI filtering only.
    """

    name: str
    supports_voice_cloning: bool = False
    supported_languages: list[str] = field(default_factory=list)
    builtin_voices: list[VoiceInfo] = field(default_factory=list)
