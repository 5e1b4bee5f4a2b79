"""``benchmark/reference`` against the program (``rho_tts_tpu_torch``) at the
tiny sizes, on the CPU, with the weights in float32 so that both compute alike:
prefill and cached decode logits against one causal forward, the code
predictor, the int8 weights, the vocoder, and the serving engine's streamed
pieces against the reference's windows."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import TINY

from benchmark import system, weights
from benchmark.reference import qwen_tts as ref

TEXT, SPEAKER = "A short line to speak.", "Vivian"


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


@pytest.fixture(scope="module")
def tree():
    return _f32(weights.make_params(TINY, 1234, "cpu"))


@pytest.fixture(scope="module")
def model(tree):
    from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel

    return QwenTTSModel(system.program_config(TINY), params=tree, device="cpu")


def test_weights_are_the_same_for_the_same_seed():
    a, b = weights.make_params(TINY, 2**33 + 1, "cpu"), weights.make_params(TINY, 2**33 + 1, "cpu")
    c = weights.make_params(TINY, 5, "cpu")
    assert torch.equal(a["talker"]["blocks"]["wqkv"], b["talker"]["blocks"]["wqkv"])
    assert torch.equal(a["codec"]["decoder"]["ups"][1], b["codec"]["decoder"]["ups"][1])
    assert not torch.equal(a["lm_head"], c["lm_head"])
    assert a["talker"]["blocks"]["wqkv"].dtype == torch.bfloat16


def test_prompt_matches_the_programs(model):
    arrays, lens, p = model._build_prompt_arrays([TEXT], SPEAKER, "English", None, None)
    ids = arrays["ids_slotted"][0][arrays["text_mask"][0] > 0]
    assert list(ids) == ref.text_ids(TEXT) and lens[0] == ref.prompt_length(TEXT)


def test_prefill_and_cached_decode_logits(model, tree):
    from rho_tts_tpu_torch.models import transformer as tfm
    from rho_tts_tpu_torch.models.qwen.model import _prefill

    cfg = model.config
    arrays, lens, p = model._build_prompt_arrays([TEXT], SPEAKER, "English", None, None)
    a = {k: torch.from_numpy(v) for k, v in arrays.items()}
    steps = 6
    ck, cv = tfm.make_kv_cache(cfg.talker, 1, p + steps, dtype=torch.float32)
    kv = torch.zeros((1, p + steps), dtype=torch.bool)
    logits, ck, cv, kv = _prefill(model.params, cfg, a["ids_slotted"], a["text_mask"],
                                  a["codes_slotted"], a["code_mask"], a["spk_ids"],
                                  a["spk_mask"], a["rope_pos"], a["attn_mask"], ck, cv, kv)
    codes = torch.randint(0, 64, (steps, 2), generator=torch.Generator().manual_seed(0))
    got = [logits[0]]
    for t in range(steps - 1):
        emb = model.params["audio_embed"][0][codes[t:t + 1, 0]] + \
            model.params["audio_embed"][1][codes[t:t + 1, 1]]
        h, _ = tfm.stack_forward(model.params["talker"], cfg.talker, emb[:, None, :],
                                 torch.tensor([[lens[0] + t]]), kv_caches=(ck, cv),
                                 cache_len=p + t, key_valid=kv)
        kv[:, p + t] = True
        got.append((h[:, -1] @ model.params["lm_head"])[0])
    with ref.run_float32():
        seq = torch.cat([ref.prompt_embeds(tree, TINY, TEXT, SPEAKER),
                         ref.code_embeds(tree, codes[:-1])])
        h = ref.talker_hidden(tree, TINY, seq, None)
        want = h[lens[0] - 1:] @ tree["lm_head"]
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-4)


def test_served_codes_read_no_gap(model, tree):
    """Greedy codes of the program (float32 here) are the reference's best:
    every gap is float32 rounding of sums taken in another order (a near tie
    read the other way), three orders under the limits at the published sizes."""
    codes = model.generate_codes([TEXT], speaker=SPEAKER, min_frames=64, max_frames=64,
                                 temperature=0.0, seeds=[3])[0]
    with ref.run_float32():
        g = ref.served_gaps(tree, TINY, TEXT, SPEAKER, torch.from_numpy(codes), 64, None, True)
    assert g["primary_tokens"] == len(codes) and g["residual_tokens"] == len(codes) - 1
    assert g["primary_gap"] < 1e-3 and g["residual_gap"] < 1e-3


def test_code_predictor_logits(model, tree):
    from rho_tts_tpu_torch.models.qwen.model import _predict_residuals

    gen = torch.Generator().manual_seed(1)
    h = torch.randn((5, TINY["talker"]["hidden"]), generator=gen)
    tok0 = torch.randint(0, 67, (5,), generator=gen)
    want = ref.residual_logits(tree, TINY, h, tok0)  # (Q, T, V)
    got = _predict_residuals(model.params, model.config, h, tok0.clamp_max(63))
    assert torch.equal(got, want.argmax(dim=-1).T)


def test_int8_weights_match_the_programs():
    from rho_tts_tpu_torch.models.quantization import quantize_weight

    w = weights.make_params(TINY, 9, "cpu")["talker"]["blocks"]["w_up"]
    q = quantize_weight(w)
    torch.testing.assert_close(ref.dequantize(w, "int8"), q["q"].float() * q["s"][:, None, :],
                               rtol=0, atol=1e-7)


def test_vocoder_waveform(model, tree):
    from rho_tts_tpu_torch.models.qwen.model import _vocode

    codes = torch.randint(0, 67, (2, 64, 2), generator=torch.Generator().manual_seed(2))
    with ref.run_float32():
        torch.testing.assert_close(_vocode(model.params, model.config, codes),
                                   ref.vocode(tree, TINY, codes), rtol=1e-4, atol=1e-5)
        low = ref.vocode(tree, TINY, codes, low_precision=True)
    assert ref.relative_error(low, ref.vocode(tree, TINY, codes)) > 0.01


def test_streamed_pieces_join_to_the_reference_windows(model, tree):
    from rho_tts_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, n_slots=2, max_prompt=64, max_frames=192, stream_context=32)
    try:
        req = eng.submit(TEXT, speaker=SPEAKER, min_frames=192, max_frames=192, stream=True,
                         seed=4, temperature=0.0)
        eng.run_until_idle()
        joined = torch.cat([p for p, _ in req.chunks(timeout=60)])
        codes = torch.from_numpy(np.asarray(req.codes)).long()
    finally:
        eng.close()
    with ref.run_float32():
        want = ref.streamed_waveform(tree, TINY, codes, 192, 64, 32)
    assert len(ref.stream_windows(192, 192, 64, 32)) == 3
    torch.testing.assert_close(joined, want, rtol=1e-4, atol=1e-5)
