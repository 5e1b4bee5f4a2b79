"""Continuous-batching TTS serving on one GPU: many concurrent requests.

The PyTorch/CUDA port of ``examples/continuous_serving.py``.
``rho_tts_tpu_torch.serving.ServingEngine`` keeps a fixed decode batch
("slots") over a ring-buffer KV cache; requests join and leave at
decode-chunk boundaries, so the batch stays full under ragged lengths:

* submit from any thread → ``ServeRequest`` future (``result()`` blocks)
* ``stream=True`` → ``req.chunks()`` yields audio pieces as decode
  chunks finish: first audio after ~one chunk, even while the request
  shares the batch with much longer utterances
* greedy sampling (``top_k=1``) is schedule-invariant: tokens match a
  one-shot ``generate_codes`` regardless of slot or batch-mates

Random weights unless ``--model-path`` names a checkpoint directory::

    python examples/torch/continuous_serving.py
    python examples/torch/continuous_serving.py --model-path tiny --device cpu
"""

import argparse

from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel
from rho_tts_tpu_torch.serving import ServingEngine


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model-path", default="1.7B")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    model = QwenTTSModel.from_pretrained(args.model_path, device=args.device)
    engine = ServingEngine(model, n_slots=4, max_prompt=128, max_frames=256)
    engine.start()  # background scheduler thread
    try:
        # A batch of plain requests…
        requests = [
            engine.submit(f"Concurrent request number {i}.", min_frames=32)
            for i in range(6)
        ]
        # …plus one streaming request sharing the same slots.
        live = engine.submit(
            "Streaming request: audio arrives chunk by chunk.",
            min_frames=96, stream=True,
        )

        first = True
        for piece, sr in live.chunks(timeout=300):
            tag = "first audio" if first else "piece"
            print(f"  live stream: {tag} — {piece.shape[0]} samples @ {sr} Hz")
            first = False

        for i, req in enumerate(requests):
            wav, sr = req.result(timeout=300)
            print(f"  request {i}: {wav.shape[0]} samples @ {sr} Hz "
                  f"({req.n_frames} frames, latency {req.t_done - req.t_submit:.2f}s)")
    finally:
        engine.stop()

    stats = engine.stats()
    print(f"served {stats['requests_done']} requests, "
          f"aggregate RTF {stats['aggregate_rtf']:.2f}")
    return stats


if __name__ == "__main__":
    main()
