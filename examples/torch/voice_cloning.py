"""Voice cloning on the GPU with the validation retry loop enabled.

The PyTorch/CUDA port of ``examples/voice_cloning.py``. Provide a clean
5-15 s reference clip and its transcript. The engine validates each
generated segment (accent-drift classifier + Whisper text match) and
retries with fresh sampling noise until the clip passes or the retry
budget is exhausted::

    python examples/torch/voice_cloning.py --reference-audio voice_sample.wav \\
        --reference-text "Transcript of what the reference clip says."
"""

import argparse
import os

from rho_tts_tpu_torch import TTSFactory


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model-path", default="Qwen/Qwen3-TTS-12Hz-1.7B-Base",
                        help="the Qwen model that clones (a Base model)")
    parser.add_argument("--chatterbox-implementation", default="standard")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--reference-audio", default="voice_sample.wav")
    parser.add_argument("--reference-text", default="Transcript of what the reference clip says.")
    parser.add_argument("--out-dir", default=".")
    args = parser.parse_args(argv)

    tts = TTSFactory.get_tts_instance(
        provider="chatterbox",
        implementation=args.chatterbox_implementation,
        reference_audio=args.reference_audio,
        device=args.device,
        max_iterations=50,                  # single-segment regeneration specialist
        accent_drift_threshold=0.17,        # reject clips with P(drift) above this
        text_similarity_threshold=0.75,     # reject clips whose STT match is below this
    )
    result = tts.generate(
        "This sentence should sound like the reference speaker.",
        os.path.join(args.out_dir, "cloned.wav"),
    )
    if result:
        print(f"Saved: {result.path}")
        print(f"  drift probability: {result.drift_prob}")
        print(f"  text similarity:   {result.text_similarity}")
        print(f"  decay ratio:       {result.decay_ratio}")

    # Qwen cloning needs the transcript of the reference audio too:
    qwen = TTSFactory.get_tts_instance(
        provider="qwen",
        model_path=args.model_path,
        reference_audio=args.reference_audio,
        reference_text=args.reference_text,
        device=args.device,
    )
    cloned = qwen.generate("Cloned with the Qwen model.",
                           os.path.join(args.out_dir, "cloned_qwen.wav"))
    qwen.close()
    tts.close()
    return result, cloned


if __name__ == "__main__":
    main()
