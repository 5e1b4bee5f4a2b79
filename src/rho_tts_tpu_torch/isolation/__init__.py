"""Dependency isolation: run providers in auto-managed venv subprocesses.

When a built-in provider's dependencies can't be imported in the host
process, the factory returns a :class:`ProviderProxy` that spawns a worker
(``python -m rho_tts_tpu_torch.isolation.worker``) in a per-provider venv
and speaks a newline-delimited JSON protocol over stdin/stdout. Audio never
crosses the pipe — only file paths. The worker owns its own CUDA context;
the parent needs no GPU and imports no model code.

Counterpart of ``rho_tts_tpu/isolation/``.
"""

from .proxy import ProviderProxy

__all__ = ["ProviderProxy"]
