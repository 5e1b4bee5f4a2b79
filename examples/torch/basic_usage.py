"""Basic usage on the GPU: named speaker, in-memory generation, batch mode.

The PyTorch/CUDA port (``rho_tts_tpu_torch``) of ``examples/basic_usage.py``.
Pass a local checkpoint directory as ``--model-path`` to use real weights;
a model name that is no directory runs with random weights (fine for
smoke-testing the pipeline)::

    python examples/torch/basic_usage.py
    python examples/torch/basic_usage.py --model-path tiny-CustomVoice --device cpu
"""

import argparse
import os

from rho_tts_tpu_torch import TTSFactory


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model-path", default="Qwen/Qwen3-TTS-12Hz-1.7B-CustomVoice")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out-dir", default=".")
    args = parser.parse_args(argv)

    # Named speaker with a CustomVoice model
    tts = TTSFactory.get_tts_instance(
        provider="qwen", model_path=args.model_path, speaker="Vivian", device=args.device,
    )

    # 1) Save straight to disk
    result = tts.generate("Hello! This is the default voice speaking.",
                          os.path.join(args.out_dir, "output.wav"))
    if result:
        print(f"Saved {result.duration_sec:.1f}s of audio to {result.path}")

    # 2) In-memory only: the waveform stays a tensor on the device until you use it
    result = tts.generate("No file is written for this one.")
    if result:
        print(f"In-memory audio: {result.numpy().shape} at {result.sample_rate} Hz")

    # 3) Batch mode: one call, several texts, numbered output files
    results = tts.generate(
        ["First item of the batch.", "Second item of the batch."],
        os.path.join(args.out_dir, "batch_output"),
    )
    for i, r in enumerate(results or []):
        print(f"item {i}: {r.path if r else 'failed'}")

    tts.close()
    return results


if __name__ == "__main__":
    main()
