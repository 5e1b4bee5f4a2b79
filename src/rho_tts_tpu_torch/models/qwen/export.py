"""Offline checkpoint export: HF safetensors or a preset -> the port's native serving dir.

    python -m rho_tts_tpu_torch.models.qwen.export SRC DST [--quantization int8|int4]
                                                   [--seed N] [--device cuda|cpu]

Counterpart of ``rho_tts_tpu/models/qwen/export.py``. SRC is an HF-layout
checkpoint directory (converted by ``models.qwen.weights``), a native
checkpoint of the port, or a preset name ("1.7B", "0.6B", "tiny": a
random-weight export from ``--seed``, for sizing and benchmarks). DST
receives the full tree and manifest that ``QwenTTSModel.from_pretrained``
serves as exported. With ``--quantization`` the talker's matmul weights are
saved quantized, so serving moves the quantized bytes and skips the
quantize pass. ``--device`` is where the model is built (default ``cuda``).
"""

from __future__ import annotations

import argparse
import logging


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("src", help="HF checkpoint dir, native checkpoint dir or preset name")
    parser.add_argument("dst", help="output native checkpoint dir")
    parser.add_argument("--quantization", choices=["int8", "int4"], default=None,
                        help="quantize the talker's matmul weights before saving")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    from .model import QwenTTSModel

    model = QwenTTSModel.from_pretrained(args.src, seed=args.seed,
                                         quantization=args.quantization, device=args.device)
    model.save_checkpoint(args.dst)
    print(f"exported {model.config.name} (quant={model.quantization}) -> {args.dst}")


if __name__ == "__main__":
    main()
