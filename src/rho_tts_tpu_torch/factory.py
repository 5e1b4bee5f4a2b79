"""Provider registry and factory of the PyTorch port.

Counterpart of ``rho_tts_tpu/factory.py``. Registration sources, in
precedence order:

1. explicit ``TTSFactory.register_provider`` calls,
2. built-in providers: ``qwen`` (:class:`rho_tts_tpu_torch.providers.qwen.QwenTTS`)
   and ``chatterbox``
   (:class:`rho_tts_tpu_torch.providers.chatterbox.ChatterboxTTS`), registered
   lazily on first use,
3. ``rho_tts_tpu_torch.providers`` entry points (third-party plugin
   packages).

The JAX package's route to its subprocess isolation layer is not ported
yet (ROADMAP queue 1 item 13), and nothing falls back to it.

Capability parity: reference ``src/rho_tts/factory.py:43-176``.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple, Type

from .engine import BaseTTS
from .exceptions import ProviderNotFoundError
from .provider_info import ProviderInfo, VoiceInfo

logger = logging.getLogger(__name__)

#: Built-in provider name → (module, attribute) for lazy import.
_BUILTINS: Dict[str, Tuple[str, str]] = {
    "qwen": ("rho_tts_tpu_torch.providers.qwen", "QwenTTS"),
    "chatterbox": ("rho_tts_tpu_torch.providers.chatterbox", "ChatterboxTTS"),
}


class TTSFactory:
    """Provider registry facade (state is class-level by design: provider
    registration is process-global, and tests snapshot/restore it)."""

    _providers: Dict[str, Type[BaseTTS]] = {}
    _default_providers_registered = False

    # -- Bootstrap ------------------------------------------------------------

    @classmethod
    def _register_default_providers(cls) -> None:
        """Import the built-ins and load plugins."""
        if cls._default_providers_registered:
            return
        cls._default_providers_registered = True

        import importlib

        for name, (module, attr) in _BUILTINS.items():
            if name not in cls._providers:
                cls._providers[name] = getattr(importlib.import_module(module), attr)

        cls._load_plugins()

    @classmethod
    def _load_plugins(cls) -> None:
        """Discover third-party providers via entry points (best-effort)."""
        try:
            from importlib.metadata import entry_points

            for ep in entry_points(group="rho_tts_tpu_torch.providers"):
                if ep.name in cls._providers:
                    continue
                try:
                    cls._providers[ep.name] = ep.load()
                    logger.info("Loaded plugin provider '%s'", ep.name)
                except Exception as exc:  # noqa: BLE001
                    logger.warning("Plugin provider '%s' failed to load: %s", ep.name, exc)
        except Exception:  # noqa: BLE001 — plugin discovery is optional
            pass

    # -- Construction -----------------------------------------------------------

    @classmethod
    def get_tts_instance(cls, provider: str = "qwen", **kwargs) -> BaseTTS:
        """Build a provider instance.

        Raises:
            ProviderNotFoundError: for unknown provider names.
        """
        cls._register_default_providers()

        provider_cls = cls._providers.get(provider)
        if provider_cls is not None:
            return provider_cls(**kwargs)

        raise ProviderNotFoundError(
            f"Unknown TTS provider: '{provider}'. "
            f"Available providers: {', '.join(cls.list_providers()) or '(none)'}. "
            f"Make sure the provider's dependencies are installed."
        )

    # -- Registration / introspection ---------------------------------------------

    @classmethod
    def register_provider(cls, name: str, provider_class: Type[BaseTTS]) -> None:
        """Add (or replace) a provider class under ``name``.

        Raises:
            TypeError: unless ``provider_class`` subclasses BaseTTS.
        """
        if not issubclass(provider_class, BaseTTS):
            raise TypeError(f"{provider_class} must inherit from BaseTTS")
        cls._providers[name] = provider_class

    @classmethod
    def list_providers(cls) -> List[str]:
        """All registered provider names."""
        cls._register_default_providers()
        return sorted(cls._providers)

    @classmethod
    def get_provider_info(cls, provider: str) -> ProviderInfo:
        """Provider metadata without model initialization.

        Raises:
            ProviderNotFoundError: for unknown provider names.
        """
        cls._register_default_providers()

        if provider in cls._providers:
            return cls._providers[provider].provider_info()
        raise ProviderNotFoundError(
            f"Unknown TTS provider: '{provider}'. "
            f"Available providers: {', '.join(cls.list_providers()) or '(none)'}."
        )

    @classmethod
    def list_voices(cls, provider: str) -> List[VoiceInfo]:
        """Built-in voices of a provider."""
        return cls.get_provider_info(provider).builtin_voices
