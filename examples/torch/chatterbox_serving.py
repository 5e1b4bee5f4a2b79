"""Chatterbox (CFG model) through the continuous-batching serving engine.

The PyTorch/CUDA port of ``examples/chatterbox_serving.py``.
``rho_tts_tpu_torch.serving_cb.ChatterboxServingEngine`` serves the
retry-heavy single-segment workload as a slot batch: each request owns a
classifier-free-guidance PAIR of transformer rows (conditional row i,
unconditional row i + n_slots) inside one ring-buffer decode loop, so k
concurrent requests cost one 2k-row batch, and a validation-rejected
segment rejoins the in-flight batch immediately
(``ChatterboxTTS(serving=True)`` wires this into the full pipeline).

Sampling noise is a pure function of (request seed, frame index): results
match the one-shot ``ChatterboxModel.generate(..., seed=seed)``
token-exactly, greedy or sampled. ``--model-path`` is the implementation
preset (``standard``, ``faster``, ``tiny``) or a native checkpoint
directory::

    python examples/torch/chatterbox_serving.py
    python examples/torch/chatterbox_serving.py --model-path tiny --device cpu
"""

import argparse
import os

from rho_tts_tpu_torch.models.chatterbox.model import ChatterboxModel
from rho_tts_tpu_torch.serving_cb import ChatterboxServingEngine


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model-path", default="standard")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if os.path.isdir(args.model_path):
        model = ChatterboxModel.from_pretrained(device=args.device, model_path=args.model_path)
    else:
        model = ChatterboxModel.from_pretrained(device=args.device, implementation=args.model_path)
    engine = ChatterboxServingEngine(model, n_slots=4, max_prompt=64, max_frames=256, chunk=32)
    engine.start()
    try:
        # Concurrent requests with different CFG weights and seeds; each
        # occupies one cond/uncond row pair of the shared slot batch.
        requests = [
            engine.submit(
                f"Concurrent chatterbox request number {i}.",
                cfg_weight=0.4 + 0.1 * i,
                min_frames=32,
                seed=100 + i,
            )
            for i in range(6)
        ]
        # A streaming request sharing the same slots: pieces arrive as
        # decode chunks retire, watermarked at their absolute offsets.
        live = engine.submit(
            "Streaming request: audio arrives chunk by chunk.",
            min_frames=96, stream=True,
        )
        for piece, sr in live.chunks(timeout=300):
            print(f"  streamed piece: {piece.shape[0] / sr * 1000:.0f} ms")
        for i, req in enumerate(requests):
            wav, sr = req.result(timeout=300)
            print(f"request {i}: {wav.shape[0] / sr:.2f} s audio "
                  f"({req.n_frames} frames, seed {req.seed})")
        stats = engine.stats()
        print(f"aggregate: {stats['requests_done']} requests, "
              f"{stats['aggregate_rtf']:.1f}x real-time")
    finally:
        engine.close()
    return stats


if __name__ == "__main__":
    main()
