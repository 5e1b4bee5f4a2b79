"""Port parity: single-stream speculative decode (``models.qwen.speculative``).

``speculative_generate_codes`` runs in both packages on the ``tiny`` target
with an identical draft (the target's own weights: p == q, near-full
acceptance) and an unrelated one (the ``draft`` preset), in both residual
modes. fp32 weights drawn with numpy at the init's scales go to the JAX
models and, through ``from_jax.params_from_numpy``, to the port; the JAX
prefill runs its Pallas kernel in interpret mode, the attention the port's
prefill reproduces. The port's round loop is a host loop where JAX's is a
``lax.while_loop``; both draw the same threefry keys, so the codes, the
emitted count and the rounds must be equal, and ``synthesize_speculative``'s
waveform within 1e-4 (fp32 vocoder).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.models.qwen import PRESETS as JPRESETS
from rho_tts_tpu.models.qwen.model import QwenTTSModel as JModel
from rho_tts_tpu.models.qwen.speculative import speculative_generate_codes as jspec
from rho_tts_tpu_torch import from_jax
from rho_tts_tpu_torch.models.qwen import PRESETS as TPRESETS
from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel as TModel
from rho_tts_tpu_torch.models.qwen.speculative import speculative_generate_codes as tspec
from rho_tts_tpu_torch.utils import prng
from test_torch_port_slice import jax_prefill_kernel  # noqa: F401 — fixture

torch.set_num_threads(1)  # several test workers share the cores


def fp32_tree(preset: str, seed: int):
    """fp32 weights of a preset's JAX tree, drawn with numpy at the init's
    scales (as ``test_torch_port_slice.fp32_params`` draws ``tiny``'s)."""
    from rho_tts_tpu.models.qwen.model import init_params

    shapes = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), JPRESETS[preset]))
    rng = np.random.default_rng(seed)

    def init(path, leaf):
        names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if leaf.ndim == 1 or names[-1] in ("attn_norm", "mlp_norm"):
            scale, shift = 0.1, 1.0
        elif names[0] == "codec" and names[1] == "rvq":
            scale, shift = 0.05, 0.0
        elif names[0] == "codec":
            scale, shift = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])), 0.0
        elif names[0] in ("talker", "lm_head"):
            scale, shift = 1.0 / np.sqrt(leaf.shape[-2]), 0.0
        else:
            scale, shift = 0.02, 0.0
        return jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32) * scale + shift)

    return jax.tree_util.tree_map_with_path(init, shapes)


def model_pair(preset: str, params):
    """The JAX model and the port on the same fp32 weights."""
    jm = JModel(JPRESETS[preset], params=params)
    tp = from_jax.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jm, TModel(TPRESETS[preset], params=tp, device="cpu")


@pytest.fixture(scope="module")
def target():
    return model_pair("tiny", fp32_tree("tiny", 0))


@pytest.fixture(scope="module")
def draft_other():
    return model_pair("draft", fp32_tree("draft", 123))


def _both(target, draft, text, seed=0, **kw):
    ref, ref_stats = jspec(target[0], draft[0], text, rng=jax.random.PRNGKey(seed), **kw)
    ours, stats = tspec(target[1], draft[1], text, rng=prng.PRNGKey(seed), **kw)
    np.testing.assert_array_equal(ours, np.asarray(ref))
    assert stats == ref_stats
    return ours, stats


@pytest.mark.parametrize("mode", ["strict", "draft"])
def test_identical_draft_codes_and_stats_equal(target, mode, jax_prefill_kernel):  # noqa: F811
    codes, stats = _both(target, target, "speculative decoding acceptance test",
                         speaker="Vivian", max_frames=48, min_frames=32, gamma=3,
                         residual_mode=mode)
    assert codes.shape[0] >= 32 and stats["tokens_per_round"] > 2.5, stats


@pytest.mark.parametrize("mode", ["strict", "draft"])
def test_unrelated_draft_codes_and_stats_equal(target, draft_other, mode,
                                               jax_prefill_kernel):  # noqa: F811
    codes, stats = _both(target, draft_other, "a different draft model proposes tokens",
                         seed=1, speaker="Ryan", max_frames=40, min_frames=16, gamma=4,
                         residual_mode=mode)
    cb = TPRESETS["tiny"].codec.codebook_size
    assert codes.shape[0] >= 16 and (codes[:, 0] < cb).all()
    assert 1.0 <= stats["tokens_per_round"] <= stats["acceptance_upper"]


def test_eos_and_round_cap_equal(target, draft_other, jax_prefill_kernel):  # noqa: F811
    """No EOS floor: the loop ends on a sampled EOS or the frame cap, at the
    same round in both packages (the port reads its condition only every
    few rounds; the rounds after the end change nothing)."""
    for seed in (2, 3):
        _both(target, draft_other, "short", seed=seed, speaker="Aria", max_frames=24,
              gamma=2, top_k=67, temperature=1.5)


def test_synthesize_speculative_matches_jax(target, draft_other, jax_prefill_kernel):  # noqa: F811
    jm, tm = target
    kw = dict(speaker="Aria", max_frames=32, min_frames=8, gamma=2)
    ref, sr = jm.synthesize_speculative("determinism", draft_other[0],
                                        rng=jax.random.PRNGKey(7), **kw)
    ours, tsr = tm.synthesize_speculative("determinism", draft_other[1],
                                          rng=prng.PRNGKey(7), **kw)
    assert tsr == sr and isinstance(ours, torch.Tensor) and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_unknown_residual_mode_and_vocab_mismatch_rejected(target, draft_other):
    with pytest.raises(ValueError, match="residual_mode"):
        tspec(target[1], draft_other[1], "x", residual_mode="bogus")

    class FakeModel:
        class config:
            audio_vocab = 999

    with pytest.raises(ValueError, match="vocabulary"):
        tspec(target[1], FakeModel(), "x")
