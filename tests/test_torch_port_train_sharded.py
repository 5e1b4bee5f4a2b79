"""Port parity of sharded training over spawned worlds of 2 and 4 ranks.

Each world is a set of gloo processes on the CPU (``start_world`` of
``test_torch_port_parallel_ranks.py``), every rank making the same calls
with the whole batch. The weights are the fp32 ``tiny`` tree drawn with
numpy (``fp32_tree``), carried to the port by ``from_jax.params_from_numpy``;
the batch has ragged ``codes_mask`` rows, and the data ranks hold different
numbers of valid frames, so a mean of per-rank means would show.

* The differentiable collectives (``copy_to_model``, ``reduce_from_model``,
  ``gather_from``, the vocab-sharded lookup): each gradient against its
  analytic value.
* ``train_step`` on DP ``(2, 1)``, TP ``(1, 2)`` and DP x TP ``(2, 2)``:
  the loss falls over 3 steps, the first-step loss is within 1e-4 of JAX's
  ``train_step`` on the same mesh of its virtual devices (JAX's own test
  holds 5e-2, ``tests/test_train_sharded.py:116``), the gathered first-step
  gradients are those of the unsharded port (an ``mp``-fold gradient would
  show here: AdamW's update nearly cancels a gradient's scale), and the
  gathered params after 2 steps are the unsharded port's.
* ``lora_train_step`` on the same meshes against the unsharded port, and on
  DP against JAX's (``tests/test_lora.py:130``, rtol 1e-5).
* ``save_checkpoint`` of TP models (Qwen dense, int8 and int4; Chatterbox)
  and ``save_train_state`` of a TP state, reloaded unmeshed bit for bit
  (and the train state onto the mesh again).

Tolerances, as measured on these worlds: losses 1e-6 relative (max 6e-8);
gradients 1e-6 absolute + 1e-5 relative (max 4e-8 absolute); params after
2 AdamW steps at lr 1e-3 1e-5 absolute + 1e-5 relative (max 3.2e-6: the
first AdamW step is g / (|g| + 1e-8) per element, so where |g| ~ 1e-8 a
gradient's rounding becomes a visible fraction of lr, as
``TRAIN_TOL`` of ``chip_smoke.py`` notes).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_port_parallel_ranks import (WORLD_TIMEOUT_S, reap_worlds,  # noqa: F401 — fixture
                                            start_world)

torch.set_num_threads(1)  # several test workers share the cores

LR = 1e-3
STEPS = 3
MESHES = {2: [("dp", 2, 1), ("tp", 1, 2)], 4: [("dp_tp", 2, 2)]}
LOSS_RTOL = 1e-6
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
PARAM_RTOL = 1e-5
JAX_LOSS_TOL = 1e-4
QUANTS = [None, "int8", "int4"]


def make_batch(seed=3, b=4, tt=8, tc=16):
    """Rows of 16, 11, 16 and 5 valid frames: 27 on the first data rank of
    two, 21 on the second."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, tc), bool)
    mask[1, 11:] = False
    mask[3, 5:] = False
    return {
        "text_ids": rng.integers(0, 512, (b, tt)).astype(np.int32),
        "codes": rng.integers(0, 64, (b, tc, 2)).astype(np.int32),
        "codes_mask": mask,
    }


def lora_tree(tree, seed=2):
    """Rank-4 adapters on ``wqkv`` / ``wo`` with a nonzero ``B`` (so the
    first step's gradient reaches both factors), as numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in ("wqkv", "wo"):
        w = np.asarray(tree["talker"]["blocks"][name])
        l, d_in, d_out = w.shape
        out[name] = {"a": (rng.standard_normal((l, d_in, 4)) / 4).astype(np.float32),
                     "b": (rng.standard_normal((l, 4, d_out)) * 0.05).astype(np.float32)}
    return out


# ---------------------------------------------------------------------------
# The port's side (runs in every rank)
# ---------------------------------------------------------------------------


def _flat(tree):
    from rho_tts_tpu_torch.models import checkpoint as ckpt

    return {k: v.detach().clone() for k, v in ckpt.flatten(tree).items()}


def _collective_grads(n):
    """Each differentiable collective's input gradient over the world's axis
    of ``n``, with the analytic value beside it."""
    from rho_tts_tpu_torch.parallel import collectives as coll
    from rho_tts_tpu_torch.parallel.mesh import create_mesh

    axis = create_mesh(n, model_parallel=n).axis("model")
    r = axis.index
    out = {}

    def grad(fn, x):
        x = x.clone().requires_grad_(True)
        fn(x).backward()
        return x.grad

    w = torch.arange(6.0).reshape(2, 3) + 10 * r  # a different weight on every rank
    out["copy_to_model"] = (grad(lambda x: (coll.copy_to_model(x, axis) * w).sum(),
                                 torch.ones(2, 3)),
                            sum(torch.arange(6.0).reshape(2, 3) + 10 * k for k in range(n)))
    c = torch.linspace(-1, 1, 6).reshape(2, 3)
    out["reduce_from_model"] = (grad(lambda x: (coll.reduce_from_model(x, axis) * c).sum(),
                                     torch.full((2, 3), float(r))), c)
    cw = torch.linspace(-1, 1, 6 * n).reshape(2 * n, 3)
    out["gather_from"] = (grad(lambda x: (coll.gather_from(x, 0, axis) * cw).sum(),
                               torch.ones(2, 3)), cw[2 * r: 2 * r + 2])
    # The vocab-sharded lookup: each shard's rows get the gradient of the
    # positions that read them, once.
    ids = torch.tensor([[0, 5, 7, 5], [2, 2, 6, 1]])
    vocab, rows = 8, 8 // n
    table = torch.zeros(rows, 3)
    g_emb = torch.linspace(0, 1, 24).reshape(2, 4, 3)
    whole = torch.zeros(vocab, 3).index_add_(0, ids.reshape(-1), g_emb.reshape(-1, 3))
    out["vocab_embed"] = (grad(lambda t: (coll.vocab_embed(t, ids, axis, differentiable=True)
                                          * g_emb).sum(), table),
                          whole[r * rows:(r + 1) * rows])
    return out


def _train_run(cfg, tree, batch, mesh=None):
    """Losses of ``STEPS`` steps, the first step's gradients and the params
    after 2 steps, gathered to the whole tree."""
    from rho_tts_tpu_torch import from_jax
    from rho_tts_tpu_torch.models.qwen import train
    from rho_tts_tpu_torch.parallel import collectives as coll
    from rho_tts_tpu_torch.parallel.mesh import mesh_axis

    params = from_jax.params_from_numpy(tree, device="cpu")
    if mesh is not None:
        params = train.shard_train_params(mesh, params, cfg)
    opt = train.make_optimizer(LR)
    state = opt.init(params)
    trained = train.leaves(params)
    _, grads = train._value_and_grad(
        lambda: train._forward_loss(params, cfg, batch, mesh=mesh), trained)
    grads = coll.sum_gradients(grads, [mesh_axis(mesh, "data")])
    grads = train._like(params, grads)
    out = {"losses": []}
    for step in range(STEPS):
        params, state, loss = train.train_step(params, state, batch, cfg, opt, mesh=mesh)
        out["losses"].append(float(loss))
        if step == 1:
            whole = params if mesh is None else train.gather_train_params(mesh, params, cfg)
            out["params"] = _flat(whole)
    out["grads"] = _flat(grads if mesh is None else train.gather_train_params(mesh, grads, cfg))
    return out


def _lora_run(cfg, tree, adapters, batch, mesh=None):
    """Losses of 2 LoRA steps, the first step's adapter gradients and the
    adapters after them; the base frozen bit for bit."""
    from rho_tts_tpu_torch import from_jax
    from rho_tts_tpu_torch.models.qwen import lora, train
    from rho_tts_tpu_torch.parallel import collectives as coll
    from rho_tts_tpu_torch.parallel.mesh import mesh_axis

    base = from_jax.params_from_numpy(tree, device="cpu")
    made = _flat(lora.init_lora(cfg, base, rank=4, seed=1))
    if mesh is not None:
        base = train.shard_train_params(mesh, base, cfg)
    # Adapters made from a rank's shards are the whole ones, as from the whole base.
    init_whole = _same(_flat(lora.init_lora(cfg, base, rank=4, seed=1)), made)
    snapshot = _flat(base)
    ad = from_jax.params_from_numpy(adapters, device="cpu")
    opt = train.make_optimizer(5e-3)
    state = opt.init(ad)
    tp = mesh_axis(mesh, "model")
    _, grads = train._value_and_grad(
        lambda: train._forward_loss(lora.apply_lora(base, ad, tp=tp, talker_cfg=cfg.talker),
                                    cfg, batch, mesh=mesh), train.leaves(ad))
    grads = coll.sum_gradients(grads, [mesh_axis(mesh, "data"), tp])
    out = {"grads": _flat(train._like(ad, grads)), "losses": [], "init_whole": init_whole}
    for _ in range(2):
        ad, state, loss = lora.lora_train_step(base, ad, state, batch, cfg, opt, mesh=mesh)
        out["losses"].append(float(loss))
    out["adapters"] = _flat(ad)
    now = _flat(base)
    out["base_frozen"] = all(torch.equal(now[k], snapshot[k]) for k in snapshot)
    return out


def _same(a, b):
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def _checkpoints(cfg, tree, batch, mesh, tmp):
    """TP ``save_checkpoint`` of both families (Qwen dense / int8 / int4)
    and TP ``save_train_state``, each reloaded unmeshed and compared bit for
    bit with the whole tree the shards were cut from."""
    from rho_tts_tpu_torch import from_jax
    from rho_tts_tpu_torch.models import checkpoint as ckpt
    from rho_tts_tpu_torch.models.chatterbox.model import PRESETS as CB_PRESETS
    from rho_tts_tpu_torch.models.chatterbox.model import ChatterboxModel
    from rho_tts_tpu_torch.models.qwen import PRESETS, QwenTTSModel, train
    from rho_tts_tpu_torch.parallel import inference

    out = {}
    models = [(f"qwen_{q}", "qwen", lambda q=q: QwenTTSModel(PRESETS["tiny"], seed=5,
                                                            device="cpu", quantization=q))
              for q in QUANTS]
    models.append(("chatterbox", "chatterbox",
                   lambda: ChatterboxModel(CB_PRESETS["tiny"], seed=5, device="cpu")))
    for name, family, build in models:
        m = build()
        whole = _flat(m.params)
        inference.enable_tensor_parallel(m, mesh)
        sharded = any(v.shape != whole[k].shape for k, v in _flat(m.params).items())
        m.save_checkpoint(f"{tmp}/{name}")
        loaded, manifest = ckpt.load_params(f"{tmp}/{name}", family=family, device="cpu")
        out[name] = (sharded, _same(_flat(loaded), whole), manifest["quantization"])

    opt = train.make_optimizer(LR)
    params = train.shard_train_params(mesh, from_jax.params_from_numpy(tree, device="cpu"), cfg)
    state = opt.init(params)
    for _ in range(2):
        params, state, _ = train.train_step(params, state, batch, cfg, opt, mesh=mesh)
    path = f"{tmp}/train_state"
    train.save_train_state(path, params, state, 2, mesh=mesh, cfg=cfg)
    whole = train.gather_train_params(mesh, params, cfg)
    moments = train._map_moments(state.state_dict(), params,
                                 lambda t: train.gather_train_params(mesh, t, cfg))
    rp, rstate, step = train.restore_train_state(path, cfg, opt, device="cpu")
    rmoments = rstate.state_dict()["state"]
    same_moments = all(torch.equal(moments["state"][i][k], rmoments[i][k])
                       for i in moments["state"] for k in train._MOMENTS)
    out["train_state_unmeshed"] = (step == 2 and _same(_flat(rp), _flat(whole)) and same_moments)
    # ... and onto the mesh again: the same shards, and the next step agrees.
    mp, mstate, _ = train.restore_train_state(path, cfg, opt, device="cpu", mesh=mesh)
    out["train_state_meshed"] = _same(_flat(mp), _flat(params))
    _, _, l1 = train.train_step(params, state, batch, cfg, opt, mesh=mesh)
    _, _, l2 = train.train_step(mp, mstate, batch, cfg, opt, mesh=mesh)
    out["train_state_meshed"] = out["train_state_meshed"] and float(l1) == float(l2)
    return out


def sharded_world(rank, n, tree, adapters, batch_np, tmp):
    from rho_tts_tpu_torch.models.qwen import PRESETS
    from rho_tts_tpu_torch.parallel.mesh import create_mesh

    base = PRESETS["tiny"]
    cfg = dataclasses.replace(base, talker=dataclasses.replace(base.talker, dtype=torch.float32))
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    out = {"collectives": _collective_grads(n), "ref": _train_run(cfg, tree, batch),
           "lora_ref": _lora_run(cfg, tree, adapters, batch)}
    for name, dp, mp in MESHES[n]:
        mesh = create_mesh(n, model_parallel=mp)
        out[name] = _train_run(cfg, tree, batch, mesh)
        out[f"lora_{name}"] = _lora_run(cfg, tree, adapters, batch, mesh)
        if mp > 1:
            out["checkpoints"] = _checkpoints(cfg, tree, batch, mesh, f"{tmp}/ckpt")
    return out


# ---------------------------------------------------------------------------
# The JAX side and the comparisons
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' rank results and JAX's first-step losses on its meshes,
    the JAX side run while each world computes."""
    import jax
    import jax.numpy as jnp

    from rho_tts_tpu.models.qwen import PRESETS
    from rho_tts_tpu.models.qwen import lora as jlora
    from rho_tts_tpu.models.qwen import train as jtrain
    from rho_tts_tpu.parallel import create_mesh
    from rho_tts_tpu.parallel.sharding import batch_sharding, qwen_param_specs, shard_params
    from test_torch_port_speculative import fp32_tree

    jtree = fp32_tree("tiny", 7)
    ntree = jax.tree.map(np.asarray, jtree)
    adapters = lora_tree(ntree)
    batch = make_batch()
    cfg = PRESETS["tiny"]
    opt = jtrain.make_optimizer(LR)
    out = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"sharded{n}")
        world = start_world(tmp, n, sharded_world, ntree, adapters, batch, str(tmp),
                            timeout=WORLD_TIMEOUT_S)
        ref = {}
        for name, dp, mp in MESHES[n]:
            mesh = create_mesh(dp * mp, model_parallel=mp)
            with mesh:
                params = shard_params(mesh, jtree, qwen_param_specs(jtree))
                jb = {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh, v.ndim))
                      for k, v in batch.items()}
                _, _, loss = jtrain.train_step(params, opt.init(params), jb, cfg, opt)
                ref[name] = float(loss)
                if mp == 1:
                    lopt = jtrain.make_optimizer(5e-3)
                    jl = jax.tree.map(jnp.asarray, adapters)
                    _, _, lloss = jlora.lora_train_step(jtree, jl, lopt.init(jl), jb, cfg, lopt)
                    ref[f"lora_{name}"] = float(lloss)
        out[n] = (world.join(), ref)
    return out


def _close(ours, ref, tol, what):
    assert list(ours) == list(ref), what
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(), err_msg=f"{what}: {k}", **tol)


def _close_norm(ours, ref, rtol, what):
    """Each leaf within ``rtol`` of the reference in norm: ``|ours - ref| <=
    rtol * |ref|`` (Frobenius; a zero leaf must be zero)."""
    assert list(ours) == list(ref), what
    for k in ref:
        err = float((ours[k].double() - ref[k].double()).norm())
        assert err <= rtol * float(ref[k].double().norm()), f"{what}: {k}: {err}"


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", ["copy_to_model", "reduce_from_model", "gather_from",
                                "vocab_embed"])
def test_collective_gradients_are_analytic(worlds, n, op):
    """``copy_to_model``'s gradient is the sum of every rank's cotangent,
    ``reduce_from_model``'s the cotangent itself (not ``n`` times it),
    ``gather_from``'s this rank's slice, the lookup's its own rows'."""
    ranks, _ = worlds[n]
    for r in range(n):
        got, want = ranks[r]["collectives"][op]
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def _mesh_cases():
    return [(n, name) for n, cases in MESHES.items() for name, _, _ in cases]


@pytest.mark.parametrize("n,name", _mesh_cases())
def test_train_step_matches_unsharded_port_and_jax(worlds, n, name):
    """The loss falls over 3 steps; every rank reports the same global loss;
    step 1 within 1e-4 of JAX's on its mesh; the gathered gradients and
    params after 2 steps are the unsharded port's."""
    ranks, jax_ref = worlds[n]
    ours, ref = ranks[0][name], ranks[0]["ref"]
    for r in range(1, n):
        assert ranks[r][name]["losses"] == ours["losses"]
    assert ours["losses"][-1] < ours["losses"][0], ours["losses"]
    np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=LOSS_RTOL)
    assert abs(ours["losses"][0] - jax_ref[name]) < JAX_LOSS_TOL
    for r in range(n):
        _close(ranks[r][name]["grads"], ref["grads"], GRAD_TOL, f"{name} rank {r} grads")
        _close_norm(ranks[r][name]["params"], ref["params"], PARAM_RTOL,
                    f"{name} rank {r} params")


def test_ragged_mask_is_one_global_mean(worlds):
    """The DP loss is JAX's one masked mean over the whole batch, not the
    mean of the two data ranks' means (27 and 21 valid frames here)."""
    ranks, jax_ref = worlds[2]
    dp = ranks[0]["dp"]["losses"][0]
    assert abs(dp - jax_ref["dp"]) < JAX_LOSS_TOL
    np.testing.assert_allclose(dp, ranks[0]["ref"]["losses"][0], rtol=LOSS_RTOL)


@pytest.mark.parametrize("n,name", _mesh_cases())
def test_lora_step_matches_unsharded_port(worlds, n, name):
    """The adapters stay whole on every rank; their summed gradients, the
    losses and the adapters after 2 steps are the unsharded port's, the
    base frozen; on DP the first loss is JAX's within rtol 1e-5.
    ``init_lora`` from a rank's shards makes the whole adapters."""
    ranks, jax_ref = worlds[n]
    key = f"lora_{name}"
    ours, ref = ranks[0][key], ranks[0]["lora_ref"]
    assert all(ranks[r][key]["init_whole"] for r in range(n))
    for r in range(1, n):  # every rank applied the same update
        assert ranks[r][key]["losses"] == ours["losses"]
        assert all(torch.equal(v, ours["adapters"][k])
                   for k, v in ranks[r][key]["adapters"].items())
    assert ours["base_frozen"]
    np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=LOSS_RTOL)
    _close(ours["grads"], ref["grads"], GRAD_TOL, f"{key} grads")
    _close_norm(ours["adapters"], ref["adapters"], PARAM_RTOL, f"{key} adapters")
    if key in jax_ref:
        np.testing.assert_allclose(ours["losses"][0], jax_ref[key], rtol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("what", [f"qwen_{q}" for q in QUANTS] + ["chatterbox",
                                                                  "train_state_unmeshed",
                                                                  "train_state_meshed"])
def test_tp_checkpoints_reload_bit_equal(worlds, n, what):
    """A TP model's ``save_checkpoint`` gathers its shards (int4 rows packed
    whole again) and the mesh's first rank writes the global tree: an
    unmeshed load is the tree the shards were cut from, bit for bit. A TP
    train state reloads unmeshed bit for bit (params and AdamW moments) and
    onto the mesh as the same shards, continuing identically."""
    ranks, _ = worlds[n]
    for r in range(n):
        res = ranks[r]["checkpoints"][what]
        if what.startswith("train_state"):
            assert res is True
        else:
            sharded, same, quant = res
            assert sharded and same
            assert quant == (None if what == "chatterbox" else dict(
                qwen_None=None, qwen_int8="int8", qwen_int4="int4")[what])
