"""Serving over several GPUs: data-parallel and tensor-parallel deployment.

The PyTorch/CUDA port of ``examples/multi_chip_serving.py``. One process
per GPU, started by ``torchrun``; every rank makes the same calls and gets
the whole result:

* ``parallelism="data"`` — weights replicated on every GPU, the batch rows
  spread over the ``data`` mesh axis. Each GPU must hold the whole model.
* ``parallelism="tensor"`` — Megatron-style sharding: attention heads and
  FFN columns split across the ``model`` axis (``parallel/sharding.py``),
  with explicit all-reduces over NCCL. Lets a model larger than one GPU's
  memory serve, at some per-token latency cost.

::

    torchrun --nproc-per-node 4 examples/torch/multi_chip_serving.py

The provider starts the process group from torchrun's environment; each
rank lands on ``cuda:{LOCAL_RANK}``. Run as one plain process, it serves
on one device (a world of one warns and stays unmeshed).
"""

import argparse

from rho_tts_tpu_torch import TTSFactory

TEXTS = [
    "Data parallel serving spreads request batches across GPUs.",
    "Tensor parallel serving shards the model itself.",
    "Throughput scales with the mesh, not the clock.",
    "Every rank makes the same call and gets the whole result.",
]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model-path", default="Qwen3-TTS-12Hz-1.7B-CustomVoice")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    # -----------------------------------------------------------------------
    # Data-parallel: batch rows spread over the mesh, weights replicated
    # -----------------------------------------------------------------------
    with TTSFactory.get_tts_instance(
        provider="qwen", model_path=args.model_path, speaker="Vivian",
        parallelism="data", device=args.device,
    ) as tts:
        results = tts.generate(TEXTS)
        for t, r in zip(TEXTS, results):
            print(f"[dp] {r.duration_sec:5.2f}s  {t[:50]}")

    # -----------------------------------------------------------------------
    # Tensor-parallel: heads / FFN sharded over the ``model`` axis
    # -----------------------------------------------------------------------
    with TTSFactory.get_tts_instance(
        provider="qwen", model_path=args.model_path, speaker="Ryan",
        parallelism="tensor", device=args.device,
    ) as tts:
        result = tts.generate("One model, many GPUs, one voice.")
        print(f"[tp] {result.duration_sec:5.2f}s  sharded decode OK")
    return results, result


if __name__ == "__main__":
    main()
