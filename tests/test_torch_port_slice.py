"""Port parity for the whole slice: ``generate_codes`` and ``synthesize`` on ``tiny``.

fp32 weights of the JAX params tree (drawn with numpy at the init's scales)
go to the JAX model and, through ``from_jax.params_from_numpy``, to the
port, so both packages run the same network:
prompt -> prefill -> chunked decode -> vocoder. The JAX prefill runs its
Pallas attention kernel in interpret mode (``RHO_TTS_TPU_FUSED_ATTENTION=1``),
the attention the port's prefill kernel reproduces: over the fresh f32
keys, where the JAX einsum fallback would read the bf16-rounded cache. Both
decode over a bf16 cache with f32 probabilities.

Greedy codes (``top_k=1``) and sampled codes from explicit seeds come out
identical, dense, int8, int4, and int8 with w8a8 prefill
(``RHO_TTS_TPU_W8A8_PREFILL=1``): the port's sampler reproduces
``jax.random``'s threefry bits, and at fp32 the int4 and w8a8 matmuls agree
to the order of sums (no int8 activation rounds apart here). No near-tie flip occurs with these seeds and texts; a flip
would show as a code mismatch from one frame on and would be reported
here rather than hidden by a looser check.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.models.qwen import PRESETS as JPRESETS
from rho_tts_tpu.models.qwen.model import QwenTTSModel as JModel
from rho_tts_tpu_torch import from_jax
from rho_tts_tpu_torch.models.qwen import PRESETS as TPRESETS
from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel as TModel

torch.set_num_threads(1)  # several test workers share the cores

TEXTS = ["port parity", "a slightly longer second line of text"]
GEN = dict(speaker="Aria", min_frames=20, max_frames=64, temperature=1.0)


@pytest.fixture(scope="module")
def fp32_params():
    """fp32 weights of the JAX tree, drawn with numpy at the init's scales."""
    from rho_tts_tpu.models.qwen.model import init_params

    shapes = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), JPRESETS["tiny"]))
    rng = np.random.default_rng(0)

    def init(path, leaf):
        names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if leaf.ndim == 1 or names[-1] in ("attn_norm", "mlp_norm"):
            scale, shift = 0.1, 1.0  # norms around 1
        elif names[0] == "codec" and names[1] == "rvq":
            scale, shift = 0.05, 0.0
        elif names[0] == "codec":
            scale, shift = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])), 0.0  # (K, Cin, Cout)
        elif names[0] in ("talker", "lm_head"):
            scale, shift = 1.0 / np.sqrt(leaf.shape[-2]), 0.0  # (..., in, out)
        else:
            scale, shift = 0.02, 0.0  # embeddings, code predictor
        a = rng.standard_normal(leaf.shape).astype(np.float32) * scale + shift
        return jnp.asarray(a)

    return jax.tree_util.tree_map_with_path(init, shapes)


@pytest.fixture
def jax_prefill_kernel(monkeypatch):
    monkeypatch.setenv("RHO_TTS_TPU_FUSED_ATTENTION", "1")
    jax.clear_caches()  # the flag is read at trace time
    yield
    jax.clear_caches()


@pytest.fixture
def w8a8_prefill(request, monkeypatch):
    """``RHO_TTS_TPU_W8A8_PREFILL=1`` for the ``"int8-w8a8"`` cases. JAX reads
    the flag at trace time, so its caches are cleared around the test."""
    if getattr(request, "param", None) == "int8-w8a8":
        monkeypatch.setenv("RHO_TTS_TPU_W8A8_PREFILL", "1")
        jax.clear_caches()
        yield
        jax.clear_caches()
    else:
        yield


def _pair(params, quant):
    """The JAX model and the port on the same weights; the port gets the JAX
    package's quantized leaves (int4 bytes and scales are identical anyway)."""
    quant = {"int8-w8a8": "int8"}.get(quant, quant)
    jm = JModel(JPRESETS["tiny"], params=params, quantization=quant)
    tp = from_jax.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu")
    tm = TModel(TPRESETS["tiny"], params=tp, device="cpu")
    return jm, tm


@pytest.mark.parametrize(
    "quant,w8a8_prefill,chunk",
    [(q, q, None) for q in (None, "int8", "int4", "int8-w8a8")]
    # Chunks of 16 frames: the minimum duration (20 frames) ends inside the
    # second, whose device-resident gate floors EOS for its first 3 steps only.
    + [(q, None, "16") for q in (None, "int8")],
    ids=["dense", "int8", "int4", "int8-w8a8", "dense-chunk16", "int8-chunk16"],
    indirect=["w8a8_prefill"],
)
def test_greedy_codes_identical(fp32_params, jax_prefill_kernel, w8a8_prefill, quant, chunk,
                                monkeypatch):
    if chunk is not None:
        monkeypatch.setenv("RHO_TTS_TPU_DECODE_CHUNK", chunk)
    jm, tm = _pair(fp32_params, quant)
    ref = jm.generate_codes(TEXTS, top_k=1, seeds=[0, 1], **GEN)
    ours = tm.generate_codes(TEXTS, top_k=1, seeds=[0, 1], **GEN)
    assert [c.shape for c in ours] == [c.shape for c in ref]
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, np.asarray(r))


@pytest.mark.parametrize(
    "quant,kw,w8a8_prefill,chunk,first",
    [
        ("int8", dict(GEN, top_k=8, seeds=[11, 12]), None, None, None),
        # Every token may be drawn: both rows sample EOS (frames 64 and 94)
        # and the lagged all-done flag stops the loop a chunk early.
        (None, dict(GEN, min_frames=4, max_frames=256, top_k=67, seeds=[2, 3]), None, None,
         None),
        ("int4", dict(GEN, top_k=8, seeds=[11, 12]), None, None, None),
        ("int8-w8a8", dict(GEN, top_k=8, seeds=[11, 12]), "int8-w8a8", None, None),
        # The minimum duration ends inside the third chunk of 32 frames: the
        # EOS row 0 draws at frame 64 without it is floored there.
        (None, dict(GEN, min_frames=70, max_frames=128, top_k=67, seeds=[2, 3]), None, "32",
         None),
        # One model serves a greedy call, then a sampled one: the second
        # call samples at its own temperature, not at the first call's.
        ("int8", dict(GEN, top_k=8, seeds=[11, 12]), None, None, dict(temperature=0.0)),
        (None, dict(GEN, top_k=8, seeds=[11, 12]), None, None, dict(temperature=0.0)),
    ],
    ids=["int8-top8", "dense-eos", "int4-top8", "int8-w8a8-top8", "dense-eos-min-frames-chunk32",
         "int8-greedy-then-top8", "dense-greedy-then-top8"],
    indirect=["w8a8_prefill"],
)
def test_sampled_codes_and_waveforms_identical(fp32_params, jax_prefill_kernel, w8a8_prefill,
                                               quant, kw, chunk, first, monkeypatch):
    """Seeded top-k sampling: identical codes; waveforms 1e-4 (fp32 vocoder)."""
    if chunk is not None:
        monkeypatch.setenv("RHO_TTS_TPU_DECODE_CHUNK", chunk)
    jm, tm = _pair(fp32_params, quant)
    if first is not None:
        ref_first = jm.generate_codes(TEXTS, **dict(kw, **first))
        ours_first = tm.generate_codes(TEXTS, **dict(kw, **first))
        for o, r in zip(ours_first, ref_first):
            np.testing.assert_array_equal(o, np.asarray(r))
    ref_codes = jm.generate_codes(TEXTS, **kw)
    ours_codes = tm.generate_codes(TEXTS, **kw)
    for o, r in zip(ours_codes, ref_codes):
        np.testing.assert_array_equal(o, np.asarray(r))
    if kw["top_k"] == 67 and kw["min_frames"] == 4:
        assert [len(c) for c in ours_codes] == [64, 94]  # the EOS path really ran
    if kw["min_frames"] == 70:
        assert min(len(c) for c in ours_codes) >= 70  # the gate floored frame 64's EOS
    if first is not None:  # the sampled codes are not the greedy ones
        assert any(not np.array_equal(o, f) for o, f in zip(ours_codes, ours_first))
    ref_wav, sr = jm.synthesize(TEXTS, **kw)
    ours_wav, tsr = tm.synthesize(TEXTS, **kw)
    assert tsr == sr
    for o, r in zip(ours_wav, ref_wav):
        assert o.shape == r.shape and torch.isfinite(o).all()
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)


def test_default_seeds_match_jax(fp32_params, jax_prefill_kernel):
    """Without seeds both packages draw ``_derive_row_seeds(rng, n)`` from a
    threefry key, ``PRNGKey(0)`` by default: the same codes, the same
    waveforms (1e-4), and the same stream."""
    from rho_tts_tpu_torch.utils import prng

    jm, tm = _pair(fp32_params, None)
    kw = dict(GEN, top_k=8)
    for jkey, tkey in ((None, None), (jax.random.PRNGKey(5), prng.PRNGKey(5))):
        ref = jm.generate_codes(TEXTS, rng=jkey, **kw)
        ours = tm.generate_codes(TEXTS, rng=tkey, **kw)
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o, np.asarray(r))
    ref_wav, _ = jm.synthesize(TEXTS, **kw)
    ours_wav, _ = tm.synthesize(TEXTS, **kw)
    for o, r in zip(ours_wav, ref_wav):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4, rtol=0)
    ref_s = np.concatenate([np.asarray(w) for w, _ in jm.stream_chunks(TEXTS[1], **kw)])
    ours_s = torch.cat([w for w, _ in tm.stream_chunks(TEXTS[1], **kw)]).numpy()
    assert ours_s.shape == ref_s.shape
    np.testing.assert_allclose(ours_s, ref_s, atol=1e-4, rtol=0)


def test_prompt_arrays_match_jax():
    jm = JModel.__new__(JModel)
    jm.config = JPRESETS["tiny"]
    from rho_tts_tpu.utils.tokenizer import load_tokenizer

    jm.tokenizer = load_tokenizer(None, vocab_size=jm.config.text_vocab)
    tm = TModel(TPRESETS["tiny"], device="cpu")
    for speaker in (None, "Aria", "someone else"):
        ref, ref_lens, ref_p = jm._build_prompt_arrays(TEXTS, speaker, "English", None, None)
        ours, lens, p = tm._build_prompt_arrays(TEXTS, speaker, "English", None, None)
        assert (lens, p) == (ref_lens, ref_p)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    # Voice cloning: [ref text][text][ref codes][BOS], the same reference
    # codes given to both (their encoder is held in test_torch_port_provider.py).
    codes = np.random.default_rng(0).integers(0, 64, (37, 2)).astype(np.int32)
    jm._reference_codes = tm._reference_codes = lambda path: codes
    ref, ref_lens, ref_p = jm._build_prompt_arrays(TEXTS, None, "English", "ref.wav", "ref text")
    ours, lens, p = tm._build_prompt_arrays(TEXTS, None, "English", "ref.wav", "ref text")
    assert (lens, p) == (ref_lens, ref_p) and ours["code_mask"].sum() == 37 * len(TEXTS)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_model_parameter_names_follow_the_jax_tree():
    tm = TModel.from_pretrained("tiny", quantization="int8", device="cpu")
    names = dict(tm.named_parameters())
    assert names["talker.blocks.wqkv.q"].dtype == torch.int8
    assert names["talker.blocks.wqkv.s"].shape == (2, 128)  # (L, out), stacked
    assert names["codec.decoder.ups.0"].shape == (32, 16, 8)  # (Cin, Cout, K)
    assert names["codec.decoder.resblocks.1.convs_d.2"].shape == (8, 8, 3)
    assert tm.params["talker"]["blocks"]["wqkv"]["q"] is names["talker.blocks.wqkv.q"]
    # A path that is no checkpoint resolves a config from its name and
    # initialises at random, as the JAX package does.
    missing = TModel.from_pretrained("/some/checkpoint/qwen-tiny", device="cpu")
    assert missing.config.name == "tiny" and missing.quantization is None


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, importlib, pkgutil\n"
        "import rho_tts_tpu_torch\n"
        "from rho_tts_tpu_torch import TTSFactory, BaseTTS\n"
        "import rho_tts_tpu_torch.providers.qwen, rho_tts_tpu_torch.ops.dsp\n"
        "assert TTSFactory.list_providers() == ['chatterbox', 'qwen']\n"
        "for m in pkgutil.walk_packages(rho_tts_tpu_torch.__path__, 'rho_tts_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'rho_tts_tpu' or m.startswith('rho_tts_tpu.')]\n"
        "print(len([m for m in sys.modules if m.startswith('rho_tts_tpu_torch')]), bad)\n"
        "assert not bad, bad\n"
    )
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 30
