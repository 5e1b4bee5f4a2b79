"""Port: native checkpoints, the JAX-export bridge, the export CLI and the HF loader.

* The port's own checkpoint (``params.pt`` + ``rho_tts_tpu_torch.json``)
  round-trips every leaf exactly, dense, int8 and int4, and
  ``from_pretrained`` follows the JAX package's rules for it.
* A JAX-exported (orbax) checkpoint reaches the port through the bridge:
  JAX ``save_checkpoint``, JAX ``checkpoint.load_params``,
  ``from_jax.params_from_numpy``, the port's ``save_checkpoint`` and
  ``from_pretrained``; its codes equal the JAX model's.
* The synthetic HF directory of ``tests/test_hf_end_to_end.py`` loads in
  both packages with int8 and int4 weights; every matched leaf of the
  port's tree equals ``params_from_numpy`` of the JAX tree.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from rho_tts_tpu.models import checkpoint as jckpt
from rho_tts_tpu.models.qwen import PRESETS as JPRESETS
from rho_tts_tpu.models.qwen.model import QwenTTSModel as JModel
from rho_tts_tpu.models.qwen.model import init_params as jinit_params
from rho_tts_tpu_torch import from_jax
from rho_tts_tpu_torch.models import checkpoint as tckpt
from rho_tts_tpu_torch.models.qwen import PRESETS as TPRESETS
from rho_tts_tpu_torch.models.qwen import export as texport
from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel as TModel

torch.set_num_threads(1)  # several test workers share the cores

TEXTS = ["checkpoint parity", "a second row"]
GEN = dict(speaker="Aria", min_frames=6, max_frames=24, top_k=1, seeds=[0, 1])


def _leaves(tree):
    return tckpt.flatten(tree)


def _assert_trees_equal(a, b):
    fa, fb = _leaves(a), _leaves(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name].dtype == fb[name].dtype, name
        assert torch.equal(fa[name].cpu(), fb[name].cpu()), name


@pytest.mark.parametrize("quant", [None, "int8", "int4"], ids=["dense", "int8", "int4"])
def test_roundtrip_every_leaf(tmp_path, quant):
    model = TModel(TPRESETS["tiny"], seed=3, quantization=quant, device="cpu")
    model.save_checkpoint(str(tmp_path))
    manifest = json.loads((tmp_path / tckpt.MANIFEST).read_text())
    assert manifest == {"format": tckpt.FORMAT, "version": 1, "family": "qwen",
                        "preset": "tiny", "quantization": quant, "variant": "base"}
    served = TModel.from_pretrained(str(tmp_path), device="cpu")
    assert served.quantization == quant and served.variant == "base"
    _assert_trees_equal(served.params, model.params)
    assert served.generate_codes(TEXTS, **GEN)[0].tolist() == \
        model.generate_codes(TEXTS, **GEN)[0].tolist()


def test_flatten_names_follow_the_module():
    model = TModel(TPRESETS["tiny"], quantization="int4", device="cpu")
    flat = tckpt.flatten(model.params)
    assert set(flat) == {name for name, _ in model.named_parameters()}
    tree = tckpt.unflatten(flat)
    assert isinstance(tree["codec"]["decoder"]["ups"], list)
    assert set(tree["talker"]["blocks"]["wqkv"]) == {"q4", "s"}


def test_manifest_rules(tmp_path):
    dense_dir, q_dir = tmp_path / "dense", tmp_path / "int8"
    TModel(TPRESETS["tiny"], device="cpu").save_checkpoint(str(dense_dir))
    TModel(TPRESETS["tiny"], quantization="int8", device="cpu").save_checkpoint(str(q_dir))
    # int4 on a dense export quantizes in the constructor
    assert TModel.from_pretrained(str(dense_dir), quantization="int4",
                                  device="cpu").quantization == "int4"
    # an explicit quantization that differs from a quantized export raises
    for bad in ("int4", "none"):
        with pytest.raises(ValueError, match="exported with quantization='int8'"):
            TModel.from_pretrained(str(q_dir), quantization=bad, device="cpu")
    assert TModel.from_pretrained(str(q_dir), quantization="int8",
                                  device="cpu").quantization == "int8"
    with pytest.raises(ValueError, match="family"):
        tckpt.load_params(str(q_dir), family="chatterbox", device="cpu")
    assert tckpt.is_native_checkpoint(str(q_dir)) and not tckpt.is_jax_checkpoint(str(q_dir))
    # a CustomVoice model path survives the export as the manifest's variant
    m = TModel(TPRESETS["tiny"], device="cpu", model_path="/x/qwen-tiny-CustomVoice")
    m.save_checkpoint(str(tmp_path / "cv"))
    assert tckpt.load_manifest(str(tmp_path / "cv"))["variant"] == "custom-voice"


def test_export_cli_int4_is_served(tmp_path, capsys):
    dst = tmp_path / "tiny-int4"
    texport.main(["tiny", str(dst), "--quantization", "int4", "--device", "cpu", "--seed", "5"])
    assert "quant=int4" in capsys.readouterr().out
    served = TModel.from_pretrained(str(dst), device="cpu")
    assert served.quantization == "int4"
    ref = TModel(TPRESETS["tiny"], seed=5, quantization="int4", device="cpu")
    _assert_trees_equal(served.params, ref.params)
    wavs, sr = served.synthesize(TEXTS, **GEN)
    assert sr == 24000 and all(torch.isfinite(w).all() for w in wavs)


def test_jax_export_through_the_bridge(tmp_path):
    """orbax export -> JAX load_params -> params_from_numpy -> port export ->
    port from_pretrained: codes identical to the JAX model's (fp32, int8)."""
    pytest.importorskip("orbax.checkpoint")
    shapes = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), JPRESETS["tiny"]))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * (0.3 if s.ndim > 1 else 0.05) + (s.ndim == 1))
        .astype(np.float32), shapes)
    jm = JModel(JPRESETS["tiny"], params=params, quantization="int8")
    jdir = tmp_path / "jax-export"
    jm.save_checkpoint(str(jdir))
    with pytest.raises(ValueError, match="params_from_numpy"):
        TModel.from_pretrained(str(jdir), device="cpu")

    tree, manifest = jckpt.load_params(str(jdir), family="qwen")
    tparams = from_jax.params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")
    bridged = TModel(TPRESETS[manifest["preset"]], params=tparams,
                     quantization=manifest["quantization"], device="cpu")
    pdir = tmp_path / "port-export"
    bridged.save_checkpoint(str(pdir))
    served = TModel.from_pretrained(str(pdir), device="cpu")
    assert served.quantization == "int8"
    ref = jm.generate_codes(TEXTS, **GEN)
    ours = served.generate_codes(TEXTS, **GEN)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, np.asarray(r))


# ---------------------------------------------------------------------------
# HF safetensors
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """The synthetic HF directory of tests/test_hf_end_to_end.py."""
    pytest.importorskip("safetensors")
    from safetensors.numpy import save_file

    from test_hf_end_to_end import author_codec, author_llama_stack, f32

    cfg = JPRESETS["tiny"]
    ref = jax.device_get(jax.jit(jinit_params, static_argnums=1)(jax.random.PRNGKey(7), cfg))
    t = cfg.talker
    tensors = author_llama_stack(ref["talker"]["blocks"], ref["talker"]["final_norm"], t.layers,
                                 t.q_heads * t.head_dim, t.kv_heads * t.head_dim)
    tensors["model.embed_tokens.weight"] = f32(ref["text_embed"])
    tensors["lm_head.weight"] = np.ascontiguousarray(f32(ref["lm_head"]).T)
    tensors["audio_embed.weight"] = f32(ref["audio_embed"])
    tensors["speaker_embed.weight"] = f32(ref["speaker_embed"])
    tensors.update(author_codec(ref["codec"], prefix="token2wav."))
    d = tmp_path_factory.mktemp("hf") / "tiny-CustomVoice"
    d.mkdir()
    save_file(tensors, str(d / "model.safetensors"))
    with open(d / "config.json", "w") as fh:
        json.dump({"model_type": "qwen3_tts",
                   "max_position_embeddings": cfg.max_position_embeddings}, fh)
    return str(d)


# Leaves the synthetic directory carries (everything but the code predictor).
_MATCHED = ("text_embed", "lm_head", "audio_embed", "speaker_embed", "talker", "codec")


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_hf_dir_loads_in_both_packages(hf_dir, quant):
    jm = JModel.from_pretrained(hf_dir, quantization=quant)
    tm = TModel.from_pretrained(hf_dir, quantization=quant, device="cpu")
    assert tm.config.name == "tiny" and tm.quantization == quant
    want = from_jax.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu")
    got = tckpt.flatten({k: tm.params[k] for k in _MATCHED})
    ref = tckpt.flatten({k: want[k] for k in _MATCHED})
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name].dtype == ref[name].dtype, name
        assert torch.equal(got[name], ref[name]), name
    assert set(tm.params["talker"]["blocks"]["w_up"]) == ({"q4", "s"} if quant == "int4"
                                                          else {"q", "s"})
    wavs, _sr = tm.synthesize(["hello"], min_frames=4, max_frames=16, seeds=[0])
    assert torch.isfinite(wavs[0]).all()


def test_hf_loader_ignores_a_dir_without_safetensors(tmp_path):
    from rho_tts_tpu_torch.models.qwen.weights import load_checkpoint

    d = tmp_path / "qwen-tiny"
    d.mkdir()
    assert load_checkpoint(str(d), TPRESETS["tiny"], device="cpu") is None
    assert TModel.from_pretrained(str(d), device="cpu").config.name == "tiny"
    assert os.listdir(d) == []
