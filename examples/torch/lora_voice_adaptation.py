"""Per-voice LoRA adaptation on the GPU: train a tiny adapter, save it, serve it.

The PyTorch/CUDA port of ``examples/lora_voice_adaptation.py``. A voice is
ADAPTED: a rank-r LoRA over the talker's projections trains against
(text, codec-codes) pairs with the same teacher-forced loss as the full
trainer (``torch.optim.AdamW``), then merges into ordinary parameters at
load — composing with int8 quantization, native serving checkpoints and
the continuous-batching engine. The base stays frozen.

Real adaptation data would come from codec-encoding recordings of the
target voice; here the batch is synthetic and the weights random::

    python examples/torch/lora_voice_adaptation.py
    python examples/torch/lora_voice_adaptation.py --model-path tiny --device cpu
"""

import argparse
import os
import tempfile

import torch

from rho_tts_tpu_torch.models.qwen import lora as lora_lib
from rho_tts_tpu_torch.models.qwen.config import resolve_config
from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel
from rho_tts_tpu_torch.models.qwen.train import make_optimizer


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model-path", default="1.7B")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = resolve_config(args.model_path)
    base = QwenTTSModel.from_pretrained(args.model_path, device=args.device)

    # 1. Train a rank-4 adapter on (text, codec-codes) pairs.
    lora, opt_state, optimizer = lora_lib.init_lora_train_state(
        cfg, base.params, rank=4, optimizer=make_optimizer(5e-3)
    )
    gen = torch.Generator().manual_seed(0)
    batch = {
        "text_ids": torch.randint(0, cfg.text_vocab, (2, 8), generator=gen),
        "codes": torch.randint(0, cfg.codec.codebook_size, (2, 16, cfg.codec.n_codebooks),
                               generator=gen),
        "codes_mask": torch.ones((2, 16), dtype=torch.bool),
    }
    batch = {k: v.to(args.device) for k, v in batch.items()}
    losses = []
    for step in range(20):
        lora, opt_state, loss = lora_lib.lora_train_step(
            base.params, lora, opt_state, batch, cfg, optimizer
        )
        losses.append(float(loss))
        if step % 5 == 0:
            print(f"  step {step}: loss {losses[-1]:.3f}")
    print(f"  adapter: {lora_lib.n_lora_params(lora) / 1e3:.0f}k params")

    # 2. Persist the adapter (megabytes, not gigabytes — one per voice).
    with tempfile.TemporaryDirectory() as d:
        adapter_dir = os.path.join(d, "my_voice")
        lora_lib.save_lora(adapter_dir, lora, meta={"scale": 1.0, "voice": "my_voice"})

        # 3. Serve it: the adapter merges at load, BEFORE quantization, so
        #    the adapted model runs int8 like any other.
        adapted = QwenTTSModel.from_pretrained(
            args.model_path, lora_path=adapter_dir, quantization="int8", device=args.device
        )
        waves, sr = adapted.synthesize(
            ["the adapted voice speaking"], min_frames=16, max_frames=64
        )
        print(f"  adapted int8 synthesis: {waves[0].shape[0]} samples @ {sr} Hz")
    return losses, waves[0]


if __name__ == "__main__":
    main()
