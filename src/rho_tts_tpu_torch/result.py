"""GenerationResult returned by ``generate()`` / ``stream()``.

The audio payload is a 1-D float32 tensor on the model's device: the
pipeline never copies it to the host unless the caller asks for it with
:meth:`GenerationResult.numpy` (or saves a file).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class GenerationResult:
    """Result of a single TTS generation.

    Attributes:
        path: File path where audio was saved, or None if in-memory only.
        audio: Raw mono waveform (1-D float32 tensor on the model's device).
        sample_rate: Sample rate in Hz.
        duration_sec: Audio duration in seconds.
        segments_count: Number of text segments generated and joined.
        format: Output audio format ("wav", "mp3", "flac", "ogg").
        drift_prob: Worst (max) accent-drift probability across segments.
        text_similarity: Worst (min) STT text similarity across segments.
        decay_ratio: RMS ratio of the last third to the first third of audio.
    """

    path: Optional[str] = None
    audio: Optional[torch.Tensor] = None
    sample_rate: int = 0
    duration_sec: float = 0.0
    segments_count: int = 0
    format: str = "wav"
    drift_prob: Optional[float] = None
    text_similarity: Optional[float] = None
    decay_ratio: Optional[float] = None

    def numpy(self) -> Optional[np.ndarray]:
        """Fetch the audio to the host as a float32 numpy array (or None)."""
        if self.audio is None:
            return None
        return self.audio.detach().float().cpu().numpy()
