"""Export-once, serve-many on the GPU: native checkpoints + speculative serving.

The PyTorch/CUDA port of ``examples/export_and_serve.py``:

1. **Export** (offline): convert an HF-layout checkpoint — or a trained or
   random-init model — into a native serving checkpoint. Quantization
   folds into the export, so a serving load moves the int8 bytes and skips
   the quantize pass::

       python -m rho_tts_tpu_torch.models.qwen.export \\
           /path/to/hf_checkpoint /srv/ckpt/qwen-1.7b-int8 --quantization int8

2. **Serve**: point the provider at the exported directory. The manifest
   carries the preset, quantization and CustomVoice/Base variant.

3. Optionally attach a **draft** for single-stream speculative decoding.

Here the export starts from random weights (``--model-path`` names a
preset or a checkpoint)::

    python examples/torch/export_and_serve.py
    python examples/torch/export_and_serve.py --model-path tiny-CustomVoice \\
        --draft-model-path draft --device cpu
"""

import argparse
import os
import tempfile

from rho_tts_tpu_torch.models.qwen import QwenTTSModel
from rho_tts_tpu_torch.providers.qwen import QwenTTS


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model-path", default="Qwen3-TTS-12Hz-1.7B-CustomVoice")
    parser.add_argument("--draft-model-path", default="draft-1.7B")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--workdir", default=None)
    args = parser.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="rho_tts_torch_export_")
    ckpt_dir = os.path.join(workdir, "qwen-int8")

    # --- 1. Export (here from random init; pass an HF dir for real weights) ---
    model = QwenTTSModel.from_pretrained(args.model_path, quantization="int8",
                                         device=args.device)
    model.save_checkpoint(ckpt_dir)
    del model
    print(f"exported pre-quantized serving checkpoint → {ckpt_dir}")

    # --- 2. Serve from the export ---------------------------------------------
    tts = QwenTTS(
        model_path=ckpt_dir,          # manifest restores preset/quant/variant
        speaker="Vivian",             # CustomVoice routing survives the export
        device=args.device,
        max_iterations=1,
        min_audio_sec=0.5,
    )
    tts.trim_silence = False          # random weights sit under the trim gate
    result = tts.generate("Serving from a native checkpoint.",
                          os.path.join(workdir, "out.wav"))
    print(f"generated {result.duration_sec:.2f}s → {result.path}")
    tts.close()

    # --- 3. Single-stream latency: speculative decoding with a draft -----------
    # For a real deployment, distill the draft first (models/qwen/distill.py);
    # any exported draft checkpoint path works here.
    fast = QwenTTS(
        model_path=ckpt_dir,
        draft_model_path=args.draft_model_path,
        speculative_gamma=4,
        speaker="Vivian",
        device=args.device,
        max_iterations=1,
        min_audio_sec=0.5,
    )
    fast.trim_silence = False
    spec = fast.generate("Speculative single-stream serving.")
    print(f"speculative path produced {spec.duration_sec:.2f}s of audio")
    fast.close()
    return result, spec


if __name__ == "__main__":
    main()
