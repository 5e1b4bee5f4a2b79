"""Port parity of pipeline parallelism (``parallel.pipeline``): the ten
cases of ``tests/test_pipeline_parallel.py``, and the pipelined training
steps held to the unpipelined port's gradients.

The pipelined cases run in spawned gloo worlds (``start_world`` of
``test_torch_port_parallel_ranks.py``): pure pipe ``(1, 2)`` in a world of
2, pure pipe ``(1, 4)`` and ``(data, pipe)`` ``(2, 2)`` in a world of 4,
every rank passing the whole batch and getting the whole output. The
weights are JAX's: the 4-layer fp32 ``CFG4`` stack from
``transformer.init_stack`` and the fp32 ``tiny`` tree (``fp32_tree``),
carried over by ``from_jax.params_from_numpy``; the JAX side computes the
unpipelined references (its own test holds its pipeline to them).

* forward: pure pipe (``M = P``), ``(data, pipe)``, more microbatches than
  stages, and per-row masks travelling with their microbatch, each within
  2e-5 of JAX's ``stack_forward`` and of the port's (JAX's tolerance);
* gradients of ``sum(h * c)`` (``c`` a fixed random cotangent, so that the
  final RMSNorm does not cancel the blocks' part as it does for
  ``sum(h ** 2)``) through the schedule, gathered over ``pipe``, within
  ``GRAD_TOL`` of the port's plain autograd and of ``jax.grad``'s;
* training on ``(2, 2)`` with 2 microbatches: the first-step gradients of
  every leaf (``train.loss_and_grads``: summed over ``data``, gathered over
  ``pipe``) within ``STEP_GRAD_TOL`` of the unpipelined port's, the loss
  within 1e-5 relative of the unpipelined step's (port and JAX), the params
  after 2 AdamW steps at lr 1e-3 within ``PARAM_TOL``, every rank's
  replicated leaves bit-equal, ``train_step(mesh=pp)`` bit-equal to
  ``pipeline_train_step``; LoRA on the same mesh: the adapters' summed
  gradients and the adapters after 2 steps against the unpipelined port's;
* the four shape guards, in process: they raise before any collective.

Tolerances: ``GRAD_TOL`` is JAX's bound for its pipeline's gradients
(measured here: at most 2.9e-6 apart, where each leaf's largest gradient
is 7.9-18); ``STEP_GRAD_TOL`` and ``PARAM_TOL`` are those of
``test_torch_port_train_sharded.py`` (measured here: gradients at most
2.4e-7 apart, each trained leaf's largest 0.0095-2.9; params after 2 steps
2.3e-7; LoRA gradients 6.7e-8, adapters 1.3e-7).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_port_parallel_ranks import (WORLD_TIMEOUT_S, reap_worlds,  # noqa: F401 — fixture
                                            start_world)

torch.set_num_threads(1)  # several test workers share the cores

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
PARAM_TOL = dict(atol=1e-5, rtol=1e-5)
LR = 1e-3


def cfg4(dtype=torch.float32):
    from rho_tts_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(hidden=32, layers=4, q_heads=4, kv_heads=2, head_dim=8, ffn=64,
                             dtype=dtype)


def stack_and_inputs(b=8, t=6, seed=0):
    """JAX's ``_stack_and_inputs`` of the JAX test, as numpy."""
    import jax
    import jax.numpy as jnp

    from rho_tts_tpu.models import transformer as jtfm

    jcfg = jtfm.TransformerConfig(hidden=32, layers=4, q_heads=4, kv_heads=2, head_dim=8,
                                  ffn=64, dtype=jnp.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = jtfm.init_stack(k1, jcfg)
    x = jax.random.normal(k2, (b, t, 32), jnp.float32)
    return jcfg, params, x


def _train_batch(seed=3, b=4, tt=4, tc=8):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, tc), bool)
    mask[2, 5:] = False
    return {"text_ids": rng.integers(0, 512, (b, tt)).astype(np.int32),
            "codes": rng.integers(0, 64, (b, tc, 2)).astype(np.int32),
            "codes_mask": mask}


MASK_LENS = [2, 4, 6, 3]


def cotangent(b=4, t=6, seed=11):
    """The fixed random ``c`` of the gradient case's loss ``sum(h * c)``."""
    return np.random.default_rng(seed).standard_normal((b, t, 32)).astype(np.float32)


# ---------------------------------------------------------------------------
# The port's side (runs in every rank)
# ---------------------------------------------------------------------------


def _forward(stack, x, n, stages, m=None, mask=None):
    from rho_tts_tpu_torch.parallel import pipeline

    mesh = pipeline.create_pipeline_mesh(n, n_stages=stages)
    params = pipeline.shard_stack_for_pipeline(mesh, stack)
    b, t = x.shape[:2]
    pos = torch.arange(t).expand(b, t)
    with torch.no_grad():
        out, caches = pipeline.pipeline_stack_forward(params, cfg4(), x, pos, attn_mask=mask,
                                                      mesh=mesh, n_microbatches=m)
    assert caches is None
    return out


def _grads(stack, x, c, n):
    """Gradients of ``sum(h * c)`` on a pure pipe of ``n`` stages, gathered
    over ``pipe``, beside plain autograd's."""
    from rho_tts_tpu_torch.models import checkpoint as ckpt
    from rho_tts_tpu_torch.models import transformer as tfm
    from rho_tts_tpu_torch.models.qwen import train
    from rho_tts_tpu_torch.parallel import pipeline, sharding

    mesh = pipeline.create_pipeline_mesh(n, n_stages=n)
    b, t = x.shape[:2]
    pos = torch.arange(t).expand(b, t)

    def grads(params, forward):
        leaves = train.leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        h = forward(params)
        return torch.autograd.grad((h.float() * c).sum(), leaves)

    plain = grads(stack, lambda p: tfm.stack_forward(p, cfg4(), x, pos)[0])
    staged = pipeline.shard_stack_for_pipeline(mesh, stack)
    names = list(ckpt.flatten(staged))
    ours = grads(staged, lambda p: pipeline.pipeline_stack_forward(p, cfg4(), x, pos,
                                                                   mesh=mesh)[0])
    tree = ckpt.unflatten(dict(zip(names, ours)))
    specs = {"blocks": pipeline.stage_specs(staged["blocks"])}
    whole = ckpt.flatten(sharding.gather_params(mesh, tree, specs))
    return {"pipe": whole, "plain": dict(zip(names, plain))}


def _flat(tree):
    from rho_tts_tpu_torch.models import checkpoint as ckpt

    return {k: v.detach().clone() for k, v in ckpt.flatten(tree).items()}


def _train(tree, adapters, batch, n):
    """On ``(n / 2, 2)`` with 2 microbatches beside the unpipelined port:
    the first-step gradients, 2 steps of ``pipeline_train_step`` and of
    ``train_step(mesh=pp)``, and 2 LoRA steps."""
    from rho_tts_tpu_torch import from_jax
    from rho_tts_tpu_torch.models.qwen import PRESETS, lora, train
    from rho_tts_tpu_torch.parallel import collectives, pipeline
    from rho_tts_tpu_torch.parallel.mesh import mesh_axis

    base = PRESETS["tiny"]
    cfg = dataclasses.replace(base, talker=dataclasses.replace(base.talker, dtype=torch.float32))
    mesh = pipeline.create_pipeline_mesh(n, n_stages=2)

    def whole():
        return from_jax.params_from_numpy(tree, device="cpu")

    def staged():
        return train.shard_train_params(mesh, whole(), cfg)

    out = {}
    ref = whole()
    out["ref_grads"] = _flat(train._like(ref, train.loss_and_grads(ref, cfg, batch)[1]))
    params = staged()
    _, grads = train.loss_and_grads(params, cfg, batch, mesh=mesh, n_microbatches=2)
    out["grads"] = _flat(train.gather_train_params(mesh, train._like(params, grads), cfg))

    opt = train.make_optimizer(LR)
    state = opt.init(ref)
    out["ref_losses"] = [float(train.train_step(ref, state, batch, cfg, opt)[2])
                         for _ in range(2)]
    out["ref_params"] = _flat(ref)
    state = opt.init(params)
    before = collectives.launches
    out["losses"] = [float(pipeline.pipeline_train_step(params, state, batch, cfg, opt, mesh,
                                                        2)[2]) for _ in range(2)]
    out["launches"] = collectives.launches - before
    out["replicated"] = {k: v for k, v in _flat(params).items()
                         if not k.startswith("talker.blocks.")}
    out["params"] = _flat(train.gather_train_params(mesh, params, cfg))
    # train_step on the pipe mesh is the pipelined step, bit for bit.
    again = staged()
    state = opt.init(again)
    losses = [float(train.train_step(again, state, batch, cfg, opt, mesh=mesh,
                                     n_microbatches=2)[2]) for _ in range(2)]
    local = _flat(params)
    out["train_step_is_pipelined"] = losses == out["losses"] and all(
        torch.equal(v, local[k]) for k, v in _flat(again).items())

    def lora_run(base_params, mesh_=None):
        ad = from_jax.params_from_numpy(adapters, device="cpu")
        stage = mesh_axis(mesh_, "pipe")
        _, g = train._value_and_grad(
            lambda: train._forward_loss(lora.apply_lora(base_params, ad, pipe=stage), cfg,
                                        batch, mesh=mesh_, n_microbatches=2),
            train.leaves(ad))
        g = collectives.sum_gradients(g, [mesh_axis(mesh_, "data"), stage])
        lopt = train.make_optimizer(5e-3)
        lstate = lopt.init(ad)
        losses = [float(lora.lora_train_step(base_params, ad, lstate, batch, cfg, lopt,
                                             mesh=mesh_, n_microbatches=2)[2])
                  for _ in range(2)]
        return {"grads": _flat(train._like(ad, g)), "losses": losses, "adapters": _flat(ad)}

    out["lora_ref"] = lora_run(whole())
    out["lora"] = lora_run(staged(), mesh)
    return out


def pipe_world(rank, n, stack_np, x_np, tree, adapters, batch_np):
    from rho_tts_tpu_torch import from_jax
    from rho_tts_tpu_torch.models import transformer as tfm

    stack = from_jax.params_from_numpy(stack_np, device="cpu")
    x = torch.from_numpy(x_np)
    out = {}
    if n == 2:
        x4 = x[:4]
        pos = torch.arange(6).expand(4, 6)
        mask = torch.arange(6)[None, :] < torch.tensor(MASK_LENS)[:, None]
        out["more_microbatches"] = _forward(stack, x4, 2, 2, m=4)
        out["more_microbatches_ref"] = tfm.stack_forward(stack, cfg4(), x4, pos)[0]
        out["mask_travels"] = _forward(stack, x4, 2, 2, m=4, mask=mask)
        out["mask_travels_ref"] = tfm.stack_forward(stack, cfg4(), x4, pos, attn_mask=mask)[0]
    else:
        out["pure_pipe"] = _forward(stack, x[:4], 4, 4)
        out["data_by_pipe"] = _forward(stack, x, 4, 2, m=2)
        out["grads"] = _grads(stack, x[:4], torch.from_numpy(cotangent()), 4)
        out["train"] = _train(tree, adapters,
                              {k: torch.from_numpy(v) for k, v in batch_np.items()}, 4)
    return out


# ---------------------------------------------------------------------------
# The JAX side and the comparisons
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from rho_tts_tpu.models import transformer as jtfm
    from rho_tts_tpu.models.qwen import PRESETS
    from rho_tts_tpu.models.qwen import train as jtrain
    from test_torch_port_speculative import fp32_tree
    from test_torch_port_train_sharded import lora_tree

    jcfg, jstack, jx = stack_and_inputs()
    stack_np, x_np = jax.tree.map(np.asarray, jstack), np.asarray(jx)
    jtree = fp32_tree("tiny", 5)
    tree = jax.tree.map(np.asarray, jtree)
    batch = _train_batch()
    started = {n: start_world(tmp_path_factory.mktemp(f"pipe{n}"), n, pipe_world, stack_np,
                              x_np, tree, lora_tree(tree), batch, timeout=WORLD_TIMEOUT_S)
               for n in (2, 4)}
    fwd = jax.jit(lambda p, x, m: jtfm.stack_forward(p, jcfg, x, jnp.broadcast_to(
        jnp.arange(6), x.shape[:2]), attn_mask=m)[0])
    mask = (jnp.arange(6)[None, :] < jnp.array(MASK_LENS)[:, None])
    ref = {"all": np.asarray(fwd(jstack, jx, jnp.ones((8, 6), bool))),
           "mask": np.asarray(fwd(jstack, jx[:4], mask))}

    def loss_plain(p):
        h, _ = jtfm.stack_forward(p, jcfg, jx[:4], jnp.broadcast_to(jnp.arange(6), (4, 6)))
        return jnp.sum(h.astype(jnp.float32) * cotangent())

    ref["grads"] = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_plain))(jstack))
    opt = jtrain.make_optimizer()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, _, loss = jtrain.train_step(jtree, opt.init(jtree), jb, PRESETS["tiny"], opt)
    ref["loss"] = float(loss)
    return {n: w.join() for n, w in started.items()}, ref


def _np(t):
    return t.detach().numpy()


class TestForwardParity:
    def test_pure_pipe_exact(self, worlds):
        ranks, ref = worlds
        for r in ranks[4]:  # every rank returns the whole output
            np.testing.assert_allclose(_np(r["pure_pipe"]), ref["all"][:4], **FWD_TOL)

    def test_data_by_pipe_mesh_exact(self, worlds):
        ranks, ref = worlds
        for r in ranks[4]:
            np.testing.assert_allclose(_np(r["data_by_pipe"]), ref["all"], **FWD_TOL)

    def test_more_microbatches_than_stages(self, worlds):
        ranks, ref = worlds
        for r in ranks[2]:
            np.testing.assert_allclose(_np(r["more_microbatches"]), ref["all"][:4], **FWD_TOL)
            np.testing.assert_allclose(_np(r["more_microbatches"]),
                                       _np(r["more_microbatches_ref"]), **FWD_TOL)

    def test_attn_mask_travels_with_microbatch(self, worlds):
        """Each row has its own validity pattern: a mask that did not ride
        with its activation would give the wrong row's attention."""
        ranks, ref = worlds
        for r in ranks[2]:
            np.testing.assert_allclose(_np(r["mask_travels"]), ref["mask"], **FWD_TOL)
            np.testing.assert_allclose(_np(r["mask_travels"]), _np(r["mask_travels_ref"]),
                                       **FWD_TOL)


class TestGradParity:
    def test_grads_match_plain_autodiff(self, worlds):
        from rho_tts_tpu_torch import from_jax
        from rho_tts_tpu_torch.models import checkpoint as ckpt

        ranks, ref = worlds
        jgrads = ckpt.flatten(from_jax.params_from_numpy(ref["grads"], device="cpu"))
        for r in ranks[4]:
            g = r["grads"]
            assert list(g["pipe"]) == list(g["plain"]) == list(jgrads)
            for k, v in g["pipe"].items():
                assert float(v.abs().max()) > 1e-2, k  # no leaf's gradient is residue
                np.testing.assert_allclose(_np(v), _np(g["plain"][k]), err_msg=k, **GRAD_TOL)
                np.testing.assert_allclose(_np(v), _np(jgrads[k]), err_msg=k, **GRAD_TOL)


def _close(ours, ref, tol, what):
    assert list(ours) == list(ref), what
    for k in ref:
        np.testing.assert_allclose(_np(ours[k]), _np(ref[k]), err_msg=f"{what}: {k}", **tol)


class TestTrainStep:
    def test_first_step_grads_match_unpipelined(self, worlds):
        """Every leaf's first-step gradient (the staged blocks, the
        embeddings upstream of the stack, the heads downstream), summed over
        ``data`` and gathered over ``pipe``: the unpipelined port's. A
        backward that lost or doubled a stage's gradient fails here."""
        ranks, _ = worlds
        for r in ranks[4]:
            _close(r["train"]["grads"], r["train"]["ref_grads"], STEP_GRAD_TOL, "grads")

    def test_loss_and_params_match_unpipelined(self, worlds):
        ranks, ref = worlds
        for r in ranks[4]:
            t = r["train"]
            np.testing.assert_allclose(t["losses"], t["ref_losses"], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(t["losses"][0], ref["loss"], rtol=1e-5, atol=1e-6)
            assert t["launches"] > 0
            _close(t["params"], t["ref_params"], PARAM_TOL, "params")

    def test_train_step_on_a_pipe_mesh_is_the_pipelined_step(self, worlds):
        ranks, _ = worlds
        assert all(r["train"]["train_step_is_pipelined"] for r in ranks[4])

    def test_lora_step_matches_unpipelined(self, worlds):
        """Whole adapters on every rank, each stage merging its layers: the
        gradients summed over ``data`` and ``pipe``, the losses and the
        adapters after 2 steps are the unpipelined port's."""
        ranks, _ = worlds
        for r in ranks[4]:
            ours, ref = r["train"]["lora"], r["train"]["lora_ref"]
            _close(ours["grads"], ref["grads"], STEP_GRAD_TOL, "lora grads")
            np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=1e-5, atol=1e-6)
            _close(ours["adapters"], ref["adapters"], PARAM_TOL, "adapters")

    def test_replicated_leaves_equal_on_every_rank(self, worlds):
        """Every rank applies the same update to the leaves outside the
        staged blocks (the embeddings upstream of the stack, the heads
        downstream, ``final_norm``): bit for bit."""
        ranks, _ = worlds
        first = ranks[4][0]["train"]
        for r in ranks[4][1:]:
            t = r["train"]
            assert t["losses"] == first["losses"]
            assert list(t["replicated"]) == list(first["replicated"])
            for k, v in t["replicated"].items():
                assert torch.equal(v, first["replicated"][k]), k


class TestValidation:
    """The guards read only the mesh's shape: they raise before any
    collective (here without a process group at all)."""

    @staticmethod
    def _inputs(cfg, b):
        from rho_tts_tpu_torch.models import transformer as tfm

        gen = torch.Generator().manual_seed(0)
        params = tfm.init_stack(gen, cfg, "cpu")  # one stage of 4: its first layer
        params["blocks"] = {k: v[:1] for k, v in params["blocks"].items()}
        x = torch.randn((b, 6, cfg.hidden), generator=gen)
        return params, x, torch.arange(6).expand(b, 6)

    def test_layers_must_divide_stages(self):
        from rho_tts_tpu_torch.parallel.pipeline import pipeline_stack_forward

        cfg = dataclasses.replace(cfg4(), layers=3)
        params, x, pos = self._inputs(cfg, 8)
        mesh = SimpleNamespace(shape={"data": 1, "pipe": 4})
        with pytest.raises(ValueError, match="divide the layer count"):
            pipeline_stack_forward(params, cfg, x, pos, mesh=mesh)

    def test_zero_microbatches_rejected(self):
        from rho_tts_tpu_torch.parallel.pipeline import pipeline_stack_forward

        params, x, pos = self._inputs(cfg4(), 4)
        mesh = SimpleNamespace(shape={"data": 1, "pipe": 4})
        with pytest.raises(ValueError, match="n_microbatches must be >= 1"):
            pipeline_stack_forward(params, cfg4(), x, pos, mesh=mesh, n_microbatches=0)

    def test_batch_must_divide_microbatches(self):
        from rho_tts_tpu_torch.parallel.pipeline import pipeline_stack_forward

        params, x, pos = self._inputs(cfg4(), 6)
        mesh = SimpleNamespace(shape={"data": 1, "pipe": 4})
        with pytest.raises(ValueError, match="divide into n_microbatches"):
            pipeline_stack_forward(params, cfg4(), x, pos, mesh=mesh)

    def test_stages_must_divide_devices(self):
        from rho_tts_tpu_torch.parallel.pipeline import create_pipeline_mesh

        with pytest.raises(ValueError, match="must divide n_devices"):
            create_pipeline_mesh(n_devices=8, n_stages=3)
