"""Port parity: the training step (``models.qwen.train``) against the JAX package.

The ``tiny`` preset at fp32: numpy-drawn weights go to the JAX tree and,
through ``from_jax.params_from_numpy``, to the port; batches come from a
seeded numpy generator. Held: the teacher-forced loss, every leaf's
gradient (``jax.grad`` against autograd), the AdamW update fed JAX's own
gradients (optax against ``torch.optim.AdamW``), three ``train_step``s,
the port's train state round-tripping bit for bit, and the kernel wrappers
refusing autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rho_tts_tpu.models.qwen import PRESETS as JPRESETS
from rho_tts_tpu.models.qwen import train as jtrain
from rho_tts_tpu_torch import from_jax
from rho_tts_tpu_torch.models import checkpoint as ckpt
from rho_tts_tpu_torch.models import transformer as ttfm
from rho_tts_tpu_torch.models.qwen import PRESETS as TPRESETS
from rho_tts_tpu_torch.models.qwen import QwenTTSModel
from rho_tts_tpu_torch.models.qwen import train as ttrain
from rho_tts_tpu_torch.ops.cuda import attention, decode_attention, int4_matmul, w8a8_matmul
from test_torch_port_speculative import fp32_tree

torch.set_num_threads(1)  # several test workers share the cores

JCFG, TCFG = JPRESETS["tiny"], TPRESETS["tiny"]
LR = 1e-3
# JAX's loss and gradients, compiled once (eager tracing is slower)
jax_value_and_grad = jax.jit(jax.value_and_grad(jtrain._forward_loss), static_argnums=1)


def to_port(tree):
    return from_jax.params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def flat(tree):
    """Port tree -> {name: f32 numpy}."""
    return {k: v.float().numpy() for k, v in ckpt.flatten(tree).items()}


def jflat(tree):
    """JAX tree -> the port's layout, flattened."""
    return flat(to_port(tree))


def make_batch(seed=1, b=2, tt=8, tc=16, ragged=True):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, tc), bool)
    if ragged:
        mask[1, tc - 5:] = False  # a shorter second row
    return {
        "text_ids": rng.integers(0, JCFG.text_vocab, (b, tt)).astype(np.int32),
        "codes": rng.integers(0, JCFG.codec.codebook_size,
                              (b, tc, JCFG.codec.n_codebooks)).astype(np.int32),
        "codes_mask": mask,
    }


def both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.fixture(scope="module")
def weights():
    return fp32_tree("tiny", 7)


def assert_close_tree(ours, ref, atol, rtol=0.0):
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=atol, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_forward_loss_and_gradients_match_jax(weights, ragged):
    """Loss 1e-5 relative; each leaf's gradient atol 1e-6 + rtol 1e-4 (the
    orders of the f32 sums differ). Leaves the loss does not reach (the
    codec, the speaker table, unused text rows) get exact zeros in both."""
    jb, tb = both(make_batch(ragged=ragged))
    jloss, jgrads = jax_value_and_grad(weights, JCFG, jb)
    tparams = to_port(weights)
    tloss, tgrads = ttrain._value_and_grad(lambda: ttrain._forward_loss(tparams, TCFG, tb),
                                          ttrain.leaves(tparams))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    names = list(ckpt.flatten(tparams))
    ours = {n: g.numpy() for n, g in zip(names, tgrads)}
    ref = jflat(jgrads)
    assert_close_tree(ours, ref, atol=1e-6, rtol=1e-4)
    assert not ours["codec.decoder.ups.0"].any() and not ours["speaker_embed"].any()
    assert all(not t.requires_grad for t in ttrain.leaves(tparams))  # flags restored


def test_adamw_update_matches_optax(weights):
    """The same gradients (JAX's) through optax's adamw and the port's
    torch.optim.AdamW, two updates: 1e-7, plus 2 f32 ulps of the value.
    The ulps: torch decays a leaf as ``p * (1 - lr * wd)``, one rounding,
    where optax adds ``-lr * (wd * p)`` to ``p``, two roundings and an add;
    at |p| ~ 0.5 one ulp is 6e-8, so the two round 1 ulp apart. Zero-gradient
    leaves decay in both."""
    jb, _ = both(make_batch())
    grads = [jax_value_and_grad(weights, JCFG, jb)[1]]
    grads.append(jax.tree.map(lambda g: -0.5 * g, grads[0]))
    jopt = jtrain.make_optimizer(LR)
    jparams, jstate = weights, jopt.init(weights)
    topt = ttrain.make_optimizer(LR)
    tparams = to_port(weights)
    tstate = topt.init(tparams)
    update = jax.jit(jopt.update)
    for g in grads:
        updates, jstate = update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        ttrain._apply_updates(topt, tstate, ttrain.leaves(tparams),
                              ttrain.leaves(to_port(g)))
    assert_close_tree(flat(tparams), jflat(jparams), atol=1e-7, rtol=2.4e-7)
    codec = flat(tparams)["codec.decoder.ups.0"]
    assert not np.array_equal(codec, flat(to_port(weights))["codec.decoder.ups.0"])


def test_three_train_steps_match_jax(weights):
    """Loss at each of 3 steps 1e-5 relative, params after them 1e-5."""
    jb, tb = both(make_batch())
    jopt, topt = jtrain.make_optimizer(LR), ttrain.make_optimizer(LR)
    jparams = jax.tree.map(jnp.array, weights)
    jstate = jopt.init(jparams)
    tparams = to_port(weights)
    tstate = topt.init(tparams)
    jl, tl = [], []
    for _ in range(3):
        jparams, jstate, jloss = jtrain.train_step(jparams, jstate, jb, JCFG, jopt)
        tparams, tstate, tloss = ttrain.train_step(tparams, tstate, tb, TCFG, topt)
        jl.append(float(jloss))
        tl.append(float(tloss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    assert_close_tree(flat(tparams), jflat(jparams), atol=1e-5)


def test_stack_fn_hook_is_used(weights):
    """``_forward_loss(stack_fn=...)`` runs the given talker forward."""
    _, tb = both(make_batch())
    tparams = to_port(weights)
    calls = []

    def stack_fn(*args, **kwargs):
        calls.append(args[3].shape)
        return ttfm.stack_forward(*args, **kwargs)

    a = ttrain._forward_loss(tparams, TCFG, tb, stack_fn=stack_fn)
    assert calls == [(2, 24)] and torch.equal(a, ttrain._forward_loss(tparams, TCFG, tb))


def test_train_step_on_model_parameters():
    """A model's registered parameters (``requires_grad=False``) train in
    place and keep their flags; a bf16 model keeps bf16 moments, as optax."""
    model = QwenTTSModel(TCFG, seed=3, device="cpu")
    before = model.params["lm_head"].clone()
    opt = ttrain.make_optimizer(LR)
    state = opt.init(model.params)
    _, tb = both(make_batch())
    params, state, loss = ttrain.train_step(model.params, state, tb, TCFG, opt)
    assert params is model.params and torch.isfinite(loss)
    assert not torch.equal(model.params["lm_head"], before)
    assert not any(p.requires_grad for p in model.parameters())
    assert state.state[model.params["lm_head"]]["exp_avg"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="not built over these params"):
        ttrain.train_step(to_port(fp32_tree("tiny", 1)), state, tb, TCFG, opt)


def test_save_restore_bit_for_bit(tmp_path, weights):
    """The train state round-trips bit for bit (params, moments, step), and
    the restored optimizer continues exactly as the saved one."""
    _, tb = both(make_batch())
    opt = ttrain.make_optimizer(LR)
    params = to_port(weights)
    state = opt.init(params)
    for _ in range(2):
        params, state, _ = ttrain.train_step(params, state, tb, TCFG, opt)
    ttrain.save_train_state(str(tmp_path / "ts"), params, state, 2)
    rparams, rstate, step = ttrain.restore_train_state(str(tmp_path / "ts"), TCFG, opt,
                                                       device="cpu")
    assert step == 2
    a, b = ckpt.flatten(params), ckpt.flatten(rparams)
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    for p, rp in zip(ttrain.leaves(params), ttrain.leaves(rparams)):
        s, rs = state.state[p], rstate.state[rp]
        assert s.keys() == rs.keys() and all(torch.equal(s[k], rs[k]) for k in s)
    grads = [torch.full_like(p, 1e-3) for p in ttrain.leaves(params)]
    ttrain._apply_updates(opt, state, ttrain.leaves(params), grads)
    ttrain._apply_updates(opt, rstate, ttrain.leaves(rparams), grads)
    a, b = ckpt.flatten(params), ckpt.flatten(rparams)
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="does not match config"):
        ttrain.restore_train_state(str(tmp_path / "ts"), TPRESETS["draft"], device="cpu")


def test_jax_train_state_raises(tmp_path, weights):
    """A JAX-package (orbax) train state raises ``ValueError`` naming the bridge."""
    opt = jtrain.make_optimizer(LR)
    jtrain.save_train_state(str(tmp_path / "jax"), weights, opt.init(weights), 0)
    with pytest.raises(ValueError, match="from_jax.params_from_numpy"):
        ttrain.restore_train_state(str(tmp_path / "jax"), TCFG, device="cpu")


def test_cache_less_forward_runs_no_kernel(weights, monkeypatch):
    """The training step's attention is plain PyTorch, as JAX's einsum: no
    kernel wrapper is reached."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was reached")

    monkeypatch.setattr(ttfm, "fused_gqa_attention", refuse)
    monkeypatch.setattr(ttfm, "decode_gqa_attention", refuse)
    _, tb = both(make_batch())
    opt = ttrain.make_optimizer(LR)
    params = to_port(weights)
    _, _, loss = ttrain.train_step(params, opt.init(params), tb, TCFG, opt)
    assert torch.isfinite(loss)


def _wrapper_args(name):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    if name == "fused_gqa_attention":
        return attention.fused_gqa_attention, [r(1, 4, 4, 16), r(1, 4, 2, 16), r(1, 4, 2, 16),
                                               torch.ones((1, 4), dtype=torch.bool)], (0, 1, 2)
    if name == "decode_gqa_attention":
        return decode_attention.decode_gqa_attention, [
            r(1, 1, 4, 16), r(1, 6, 2, 16), r(1, 6, 2, 16),
            torch.ones((1, 6), dtype=torch.bool)], (0, 1, 2)
    if name == "w8a8_matmul":
        return w8a8_matmul.w8a8_matmul, [
            torch.randint(-127, 128, (4, 32), dtype=torch.int8, generator=g), r(4, 1).abs(),
            torch.randint(-127, 128, (32, 16), dtype=torch.int8, generator=g), r(16).abs(),
            torch.float32], (1, 3)
    return int4_matmul.int4_matmul, [
        r(3, 64), torch.randint(-128, 128, (32, 16), dtype=torch.int8, generator=g),
        r(16).abs()], (0, 2)


@pytest.mark.parametrize("name", ["fused_gqa_attention", "decode_gqa_attention",
                                  "w8a8_matmul", "int4_matmul"])
def test_kernel_wrappers_refuse_autograd(name):
    """An input that requires grad under grad mode raises, naming the plain
    version; under ``no_grad`` the same call runs."""
    fn, args, float_args = _wrapper_args(name)
    out = fn(*args)
    for i in float_args:
        grad_args = list(args)
        grad_args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="has no backward.*reference_"):
            fn(*grad_args)
        with torch.no_grad():
            torch.testing.assert_close(fn(*grad_args), out, rtol=0, atol=0)
