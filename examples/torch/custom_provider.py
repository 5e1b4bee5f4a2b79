"""Registering a custom provider with the port's factory.

The PyTorch/CUDA port of ``examples/custom_provider.py``. A provider
implements two members: ``_generate_audio`` (text → waveform) and
``sample_rate``. Everything else — segmentation, validation retries,
crossfade joining, saving, streaming, async — comes from the engine, whose
DSP runs on ``--device``. The toy provider needs no model, so this example
takes no ``--model-path``::

    python examples/torch/custom_provider.py --device cpu
"""

import argparse
import os

import numpy as np

from rho_tts_tpu_torch import BaseTTS, TTSFactory


class BeepTTS(BaseTTS):
    """Toy provider that renders each segment as a 440 Hz beep."""

    def __init__(self, beep_hz: float = 440.0, **kwargs):
        super().__init__(**kwargs)
        self.beep_hz = beep_hz

    def _generate_audio(self, text, **kwargs):
        # One second of tone per 20 characters of text
        duration = max(len(text) / 20.0, 0.5)
        t = np.arange(int(self.sample_rate * duration)) / self.sample_rate
        return (0.3 * np.sin(2 * np.pi * self.beep_hz * t)).astype(np.float32)

    @property
    def sample_rate(self) -> int:
        return 24000


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out-dir", default=".")
    args = parser.parse_args(argv)

    TTSFactory.register_provider("beep", BeepTTS)
    tts = TTSFactory.get_tts_instance("beep", beep_hz=660.0, device=args.device)
    result = tts.generate("Beep boop. This text becomes tones.",
                          os.path.join(args.out_dir, "beeps.wav"))
    print("saved:", result.path, f"({result.segments_count} segments joined)")
    return result


if __name__ == "__main__":
    main()
