"""Port parity: draft distillation (``models.qwen.distill``) against the JAX package.

A ``tiny`` target and a ``draft``-preset draft at fp32 (numpy-drawn weights
carried over through ``from_jax.params_from_numpy``). Held: the corpus, the
learning-rate schedule over its first 30 counts (optax's), the rollouts'
codes under the same key (the JAX prefill in interpret mode, the attention
the port's prefill reproduces), ``distill_loss`` and its overlap on one
batch, three ``distill_step``s under the distillation schedule, and
``distill_draft`` raising the overlap in place on the port's own models.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rho_tts_tpu.models.qwen import distill as jdistill
from rho_tts_tpu_torch.models.qwen import PRESETS as TPRESETS
from rho_tts_tpu_torch.models.qwen import QwenTTSModel
from rho_tts_tpu_torch.models.qwen import distill as tdistill
from rho_tts_tpu_torch.models.qwen import train as ttrain
from rho_tts_tpu_torch.models.qwen.speculative import speculative_generate_codes
from rho_tts_tpu_torch.utils import prng
from test_torch_port_slice import jax_prefill_kernel  # noqa: F401 — fixture
from test_torch_port_speculative import fp32_tree, model_pair
from test_torch_port_train import flat, to_port

torch.set_num_threads(1)  # several test workers share the cores

TEXTS = tdistill.make_corpus(8, seed=0)
FRAMES, BATCH = 12, 4


@pytest.fixture(scope="module")
def pair():
    """((JAX target, port target), (JAX draft, port draft)) on fp32 weights."""
    return model_pair("tiny", fp32_tree("tiny", 0)), model_pair("draft", fp32_tree("draft", 1))


@pytest.fixture(scope="module")
def batches(pair):
    """The port's rollouts of TEXTS (two batches), and the same as JAX arrays."""
    tb = tdistill.build_batches(pair[0][1], TEXTS, FRAMES, BATCH, rng=prng.PRNGKey(0))
    jb = [{k: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64 else v.numpy())
           for k, v in b.items()} for b in tb]
    return jb, tb


def test_make_corpus_equals_jax():
    for seed in (0, 3):
        assert tdistill.make_corpus(16, seed=seed) == jdistill.make_corpus(16, seed=seed)


@pytest.mark.parametrize("steps", [300, 20, 1])
def test_schedule_matches_optax(steps):
    """``distill_draft``'s schedule for ``steps`` over its first 30 counts,
    against optax's ``warmup_cosine_decay_schedule`` (float32 both; 1e-6
    relative for the cosine's last bit)."""
    lr = 2e-3
    kw = dict(init_value=0.0, peak_value=lr, warmup_steps=min(20, max(steps // 10, 1)),
              decay_steps=max(steps, 2), end_value=lr * 0.02)
    ours = tdistill.warmup_cosine_decay_schedule(**kw)
    ref = optax.warmup_cosine_decay_schedule(**kw)
    got = [ours(c) for c in range(30)]
    np.testing.assert_allclose(got, [float(ref(jnp.int32(c))) for c in range(30)], rtol=1e-6)
    assert got[0] == 0.0


def test_build_batches_codes_equal_jax(pair, batches, jax_prefill_kernel):  # noqa: F811
    """The rollouts' codes (sampled, top-k) and prompt arrays equal JAX's
    under the same key."""
    ref = jdistill.build_batches(pair[0][0], TEXTS, FRAMES, BATCH, rng=jax.random.PRNGKey(0))
    _, tb = batches
    assert len(ref) == len(tb) == 2
    for r, b in zip(ref, tb):
        assert r.keys() == b.keys()
        for k in r:
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(r[k]), err_msg=k)
        assert b["codes"].shape == (BATCH, FRAMES, 2)


def test_distill_loss_matches_jax(pair, batches):
    """Loss and overlap on one batch: 1e-5 relative at fp32."""
    (jt, tt), (jd, td) = pair
    jb, tb = batches
    temp = 0.9
    loss_fn = jax.jit(jdistill.distill_loss, static_argnums=(2, 3, 6))
    jloss, jover = loss_fn(jd.params, jt.params, jd.config, jt.config, jb[0], jnp.float32(temp), 5)
    tloss, tover = tdistill.distill_loss(td.params, tt.params, td.config, tt.config, tb[0],
                                         torch.tensor(temp), 5)
    np.testing.assert_allclose([float(tloss), float(tover)], [float(jloss), float(jover)],
                               rtol=1e-5)
    assert 0.0 < float(tover) <= 1.0


def test_three_distill_steps_match_jax(pair, batches):
    """Three steps under the distillation schedule (warm-up from 0: the first
    step moves only Adam's moments): loss and overlap each step 1e-5
    relative, the draft after them 1e-5."""
    (jt, tt), (jd, td) = pair
    jb, tb = batches
    kw = dict(init_value=0.0, peak_value=1e-2, warmup_steps=3, decay_steps=30,
              end_value=2e-4)
    jopt = optax.adamw(optax.warmup_cosine_decay_schedule(**kw), weight_decay=0.0)
    topt = ttrain.AdamW(tdistill.warmup_cosine_decay_schedule(**kw), weight_decay=0.0)
    jparams = jax.tree.map(jnp.array, jd.params)
    tparams = to_port(jd.params)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    first = flat(tparams)
    jhist, thist = [], []
    for step in range(3):
        jparams, jstate, jloss, jover = jdistill.distill_step(
            jparams, jstate, jt.params, jb[step % 2], jd.config, jt.config, jnp.float32(0.9), 5,
            jopt)
        tparams, tstate, tloss, tover = tdistill.distill_step(
            tparams, tstate, tt.params, tb[step % 2], td.config, tt.config, torch.tensor(0.9), 5,
            topt)
        jhist.append([float(jloss), float(jover)])
        thist.append([float(tloss), float(tover)])
        if step == 0:  # lr 0 at count 0
            assert all(np.array_equal(v, first[k]) for k, v in flat(tparams).items())
    np.testing.assert_allclose(thist, jhist, rtol=1e-5)
    ref = flat(to_port(jparams))
    for k, v in flat(tparams).items():
        np.testing.assert_allclose(v, ref[k], atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def tiny_pair():
    """The port's own target and draft (random tiny weights, bf16)."""
    return (QwenTTSModel(TPRESETS["tiny"], seed=0, device="cpu"),
            QwenTTSModel(TPRESETS["tiny"], seed=1, device="cpu"))


def test_distill_draft_raises_overlap(tiny_pair):
    """``distill_draft`` trains the draft's registered parameters in place
    (flags kept), its overlap rises, and a 1-step run changes nothing (its
    step runs at the schedule's initial 0.0)."""
    target, _ = tiny_pair
    short = QwenTTSModel(TPRESETS["tiny"], seed=1, device="cpu")
    before = short.params["lm_head"].clone()
    s1 = tdistill.distill_draft(target, short, n_texts=8, seq_frames=FRAMES, batch_size=BATCH,
                                steps=1, log_every=0)
    assert torch.equal(short.params["lm_head"], before) and s1["steps"] == 1

    draft = QwenTTSModel(TPRESETS["tiny"], seed=1, device="cpu")
    stats = tdistill.distill_draft(target, draft, n_texts=8, seq_frames=FRAMES,
                                   batch_size=BATCH, steps=8, log_every=0)
    assert not torch.equal(draft.params["lm_head"], before)
    assert not any(p.requires_grad for p in draft.parameters())
    assert len(stats["overlaps"]) == 8 and 0.0 < stats["overlap"] <= 1.0
    assert stats["overlaps"][-1] > stats["overlaps"][0]
    assert stats["overlap"] > s1["overlap"] - 0.05

    codes, st = speculative_generate_codes(target, draft, "acceptance check text",
                                           speaker="Vivian", max_frames=16, min_frames=16,
                                           gamma=3)
    assert codes.ndim == 2 and codes.shape[0] >= 1 and st["rounds"] >= 1


def test_mismatched_vocab_and_steps_rejected(tiny_pair):
    target, draft = tiny_pair
    cfg = TPRESETS["tiny"]
    bad = dataclasses.replace(cfg, codec=dataclasses.replace(cfg.codec, codebook_size=32))
    with pytest.raises(ValueError, match="vocabulary"):
        tdistill.distill_draft(target, QwenTTSModel(bad, seed=1, device="cpu"), steps=1)
    with pytest.raises(ValueError, match="steps must be"):
        tdistill.distill_draft(target, draft, steps=0)
