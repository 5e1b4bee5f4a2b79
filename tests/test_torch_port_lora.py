"""Port parity: LoRA voice adaptation (``models.qwen.lora``) against the JAX package.

The ``tiny`` preset at fp32 (numpy-drawn weights carried over through
``from_jax.params_from_numpy``; the JAX adapters too). Held: the merge with
a nonzero ``B`` and the zero-init merge (bit for bit), three
``lora_train_step``s with the base frozen bit for bit, the adapter files
round-tripping bit for bit, a JAX adapter directory refused, and
``QwenTTSModel(lora_path=...)`` / ``QwenTTS(lora_path=...)`` serving the
merged weights (before quantization; a quantized base raises).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.models.qwen import PRESETS as JPRESETS
from rho_tts_tpu.models.qwen import lora as jlora
from rho_tts_tpu.models.qwen import train as jtrain
from rho_tts_tpu_torch.models import checkpoint as ckpt
from rho_tts_tpu_torch.models.qwen import PRESETS as TPRESETS
from rho_tts_tpu_torch.models.qwen import QwenTTSModel
from rho_tts_tpu_torch.models.qwen import lora as tlora
from rho_tts_tpu_torch.models.qwen import train as ttrain
from rho_tts_tpu_torch.models.qwen.model import init_params
from rho_tts_tpu_torch.providers.qwen import QwenTTS
from test_torch_port_speculative import fp32_tree
from test_torch_port_train import both, flat, make_batch, to_port

torch.set_num_threads(1)  # several test workers share the cores

JCFG, TCFG = JPRESETS["tiny"], TPRESETS["tiny"]


@pytest.fixture(scope="module")
def weights():
    return fp32_tree("tiny", 11)


def flat_any(tree):
    return {f"{k}.{n}": v for k, ab in tree.items() for n, v in ab.items()}


def nonzero_adapter(weights, targets=tlora.DEFAULT_TARGETS):
    """JAX's ``init_lora`` with ``B`` drawn nonzero, so the merge does work."""
    lora = jlora.init_lora(JCFG, weights, rank=4, targets=targets, seed=2)
    rng = np.random.default_rng(9)
    return {k: {"a": ab["a"],
                "b": jnp.asarray(rng.standard_normal(ab["b"].shape).astype(np.float32) * 0.05)}
            for k, ab in lora.items()}


def test_init_lora_shapes_and_zero_merge(weights):
    """Shapes, dtypes and size as JAX's; ``B`` zero, so the merge equals the
    base bit for bit; an unknown target raises."""
    tparams = to_port(weights)
    jl = jlora.init_lora(JCFG, weights, rank=4, targets=tlora.TARGETS)
    tl = tlora.init_lora(TCFG, tparams, rank=4, targets=tlora.TARGETS)

    def spec(tree):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in flat_any(tree).items()}

    assert spec(tl) == spec(jl)
    assert tlora.n_lora_params(tl) == jlora.n_lora_params(jl)
    merged = tlora.apply_lora(tparams, tl)
    for name in tlora.TARGETS:
        assert torch.equal(merged["talker"]["blocks"][name], tparams["talker"]["blocks"][name])
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        tlora.init_lora(TCFG, tparams, targets=("nope",))


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_apply_lora_matches_jax(weights, scale):
    """The merge ``(w + einsum(a, b) * scale).astype(w.dtype)`` with a
    nonzero ``B``, on every target: 1e-6 at fp32 (the rank-4 sums' order)."""
    jl = nonzero_adapter(weights, tlora.TARGETS)
    ref = jlora.apply_lora(weights, jl, scale=scale)
    ours = tlora.apply_lora(to_port(weights), to_port(jl), scale=scale)
    for name in tlora.TARGETS:
        np.testing.assert_allclose(ours["talker"]["blocks"][name].numpy(),
                                   np.asarray(ref["talker"]["blocks"][name]), atol=1e-6)


def test_three_lora_steps_match_jax(weights):
    """Loss at each of 3 ``lora_train_step``s 1e-5 relative, the adapters
    after them 1e-5; the base is never written (bit for bit)."""
    jb, tb = both(make_batch())
    jl = nonzero_adapter(weights)
    jopt, topt = jtrain.make_optimizer(5e-3), ttrain.make_optimizer(5e-3)
    jstate = jopt.init(jl)
    tbase = to_port(weights)
    snapshot = {k: v.clone() for k, v in ckpt.flatten(tbase).items()}
    tl = to_port(jl)
    tstate = topt.init(tl)
    jlosses, tlosses = [], []
    for _ in range(3):
        jl, jstate, jloss = jlora.lora_train_step(weights, jl, jstate, jb, JCFG, jopt)
        tl, tstate, tloss = tlora.lora_train_step(tbase, tl, tstate, tb, TCFG, topt)
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    ref = flat(to_port(jl))
    for k, v in flat(tl).items():
        np.testing.assert_allclose(v, ref[k], atol=1e-5, err_msg=k)
    assert all(torch.equal(v, snapshot[k]) for k, v in ckpt.flatten(tbase).items())
    assert not any(t.requires_grad for t in ttrain.leaves(tbase) + ttrain.leaves(tl))


def test_save_load_roundtrip_and_jax_dir_raises(tmp_path, weights):
    """Adapters and meta round-trip bit for bit; a JAX-package (orbax)
    adapter directory raises ``ValueError`` naming the bridge."""
    tl = to_port(nonzero_adapter(weights))
    tlora.save_lora(str(tmp_path / "voice"), tl, meta={"scale": 0.5, "voice": "demo"})
    loaded, meta = tlora.load_lora(str(tmp_path / "voice"), device="cpu")
    assert meta == {"scale": 0.5, "voice": "demo"}
    a, b = ckpt.flatten(tl), ckpt.flatten(loaded)
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    jlora.save_lora(str(tmp_path / "jax"), nonzero_adapter(weights), meta={"scale": 1.0})
    with pytest.raises(ValueError, match="from_jax.params_from_numpy"):
        tlora.load_lora(str(tmp_path / "jax"), device="cpu")


def test_model_lora_path_merges_before_quantization(tmp_path, weights):
    """``QwenTTSModel(lora_path=...)`` holds ``apply_lora``'s weights (with
    the saved scale), as ordinary tensors; a zero-init adapter gives the base
    bit for bit; int8 quantizes the merged weights; a quantized base raises."""
    tparams = to_port(weights)
    tl = to_port(nonzero_adapter(weights))
    tlora.save_lora(str(tmp_path / "a"), tl, meta={"scale": 0.5})
    model = QwenTTSModel(TCFG, params=tparams, device="cpu", lora_path=str(tmp_path / "a"))
    ref = tlora.apply_lora(tparams, tl, scale=0.5)["talker"]["blocks"]
    for name in tlora.DEFAULT_TARGETS:
        w = model.params["talker"]["blocks"][name]
        assert torch.equal(w, ref[name]) and not w.is_inference() and not w.requires_grad

    tlora.save_lora(str(tmp_path / "zero"), tlora.init_lora(TCFG, tparams, rank=4))
    zero = QwenTTSModel(TCFG, params=tparams, device="cpu", lora_path=str(tmp_path / "zero"))
    a, b = ckpt.flatten(zero.params), ckpt.flatten(tparams)
    assert all(torch.equal(a[k], b[k]) for k in b)

    q = QwenTTSModel(TCFG, params=tparams, device="cpu", quantization="int8",
                     lora_path=str(tmp_path / "a"))
    plain = QwenTTSModel(TCFG, params=dict(tparams, talker={**tparams["talker"], "blocks": ref}),
                         device="cpu", quantization="int8")
    assert torch.equal(q.params["talker"]["blocks"]["wqkv"]["q"],
                       plain.params["talker"]["blocks"]["wqkv"]["q"])
    with pytest.raises(ValueError, match="DENSE base"):
        QwenTTSModel(TCFG, params=q.params, device="cpu", lora_path=str(tmp_path / "a"))


def test_provider_serves_the_merged_weights(tmp_path):
    """``QwenTTS(lora_path=...)`` loads its random base from its seed, merges
    the adapter and generates; the zero-adapter provider's codes equal the
    plain provider's."""
    seed = 5
    base = init_params(TCFG, seed, "cpu")
    lora = tlora.init_lora(TCFG, base, rank=2, seed=1)
    with torch.no_grad():
        lora["wo"]["b"].normal_(0.0, 0.05, generator=torch.Generator().manual_seed(3))
    tlora.save_lora(str(tmp_path / "v"), lora)
    kw = dict(device="cpu", model_path="tiny-CustomVoice", speaker="Vivian", seed=seed,
              max_iterations=1, min_audio_sec=1.0)
    tts = QwenTTS(lora_path=str(tmp_path / "v"), **kw)
    model = tts._load_model()
    merged = tlora.apply_lora(base, lora)["talker"]["blocks"]
    assert torch.equal(model.params["talker"]["blocks"]["wo"], merged["wo"])
    assert torch.equal(model.params["text_embed"], base["text_embed"])
    out = tts.generate("an adapted voice")
    assert out is not None and bool(torch.isfinite(out.audio).all())

    tlora.save_lora(str(tmp_path / "zero"), tlora.init_lora(TCFG, base, rank=2))
    codes = []
    for lp in (str(tmp_path / "zero"), None):
        m = QwenTTS(lora_path=lp, **kw)._load_model()
        codes.append(m.generate_codes(["same codes"], speaker="Vivian", max_frames=16,
                                      seeds=[4])[0])
    np.testing.assert_array_equal(codes[0], codes[1])
