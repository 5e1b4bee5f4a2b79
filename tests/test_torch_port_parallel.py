"""The port's mesh layer in one process (``rho_tts_tpu_torch.parallel``).

Held against the JAX package's ``parallel`` on the ``tiny`` presets:
``default_mesh_shape``, the spec trees leaf by leaf (dense, int8 ``{q,s}``
and int4 ``{q4,s}``), the three shard cuts the port makes by hand (the
per-head ``wqkv`` columns, the int4 row repack, the vocab-sharded text
embedding) against the whole weight, and meshes of one over a gloo world
of one, whose codes equal the unmeshed model's. The spawned worlds of 2 and
4 ranks are ``test_torch_port_parallel_{ranks,serving,providers}.py``.
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from rho_tts_tpu.models.chatterbox import model as jcb
from rho_tts_tpu.models.qwen import PRESETS as JPRESETS
from rho_tts_tpu.models.qwen.model import init_params as jinit
from rho_tts_tpu.models.quantization import quantize_stack as jquantize
from rho_tts_tpu.parallel import mesh as jmesh
from rho_tts_tpu.parallel import sharding as jsharding
from rho_tts_tpu_torch import from_jax
from rho_tts_tpu_torch.models.qwen import PRESETS as TPRESETS
from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel as TModel
from rho_tts_tpu_torch.models.quantization import pack_int4
from rho_tts_tpu_torch.ops.cuda.int4_matmul import unpack_int4
from rho_tts_tpu_torch.parallel import collectives, inference, mesh, sharding

torch.set_num_threads(1)  # several test workers share the cores

TEXTS = ["mesh parity check", "a second row", "three"]


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one rank, torn down after the test."""
    mesh.initialize_distributed(f"file://{tmp_path / 'pg'}", 1, 0, device="cpu")
    yield
    mesh.shutdown_distributed()


class FakeMesh:
    """The view ``shard_params`` needs of rank ``index`` on a mesh: shapes
    and axes, no process groups (the cuts are local)."""

    def __init__(self, model: int, index: int, data: int = 1, data_index: int = 0):
        self.shape = {"data": data, "model": model}
        self.axis_names = ("data", "model")
        self._axes = {"data": mesh.Axis("data", data, data_index),
                      "model": mesh.Axis("model", model, index)}

    def axis(self, name):
        return self._axes[name]

    def write_on_first_rank(self, write):
        if self._axes["data"].index == 0 and self._axes["model"].index == 0:
            write()


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (str(i),)))
        return out
    return {prefix: tree}


def _jax_spec_map(specs):
    """JAX's PartitionSpec tree flattened to ``path -> tuple``."""
    return {tuple(k.split("/")): tuple(v) for k, v in jsharding._flatten_specs(specs).items()}


@pytest.mark.parametrize("n", range(1, 9))
def test_default_mesh_shape_matches_jax(n):
    for mp in (None, 1, 2):
        if mp is None or n % mp == 0:
            assert mesh.default_mesh_shape(n, mp) == jmesh.default_mesh_shape(n, mp)


def _tiny_trees(family: str, quant):
    """The JAX tiny tree (quantized as asked) and the port's copy of it."""
    if family == "qwen":
        jp = jinit(jax.random.PRNGKey(0), JPRESETS["tiny"])
    else:
        jp = jcb.init_params(jax.random.PRNGKey(0), jcb.PRESETS["tiny"])
    if quant is not None:
        jp = {**jp, "talker": jquantize(jp["talker"], quant)}
    tp = from_jax.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


@pytest.mark.parametrize("family", ["qwen", "chatterbox"])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_spec_trees_match_jax_leaf_by_leaf(family, quant):
    jp, tp = _tiny_trees(family, quant)
    ours = {k: tuple(v) for k, v in _flat(sharding.param_specs_for(tp)).items()}
    ref = _jax_spec_map(jsharding.param_specs_for(jp))
    assert ours == ref
    # Every spec has one entry per axis of its leaf (or is fully replicated).
    leaves = _flat(tp)
    assert set(ours) == set(leaves)
    for path, spec in ours.items():
        assert spec == () or len(spec) == leaves[path].dim(), path
    blocks = sharding.param_specs_for(tp)["talker"]["blocks"]
    if quant is not None:
        qkey = "q4" if quant == "int4" else "q"
        assert blocks["wqkv"] == {qkey: (None, None, "model"), "s": (None, "model")}
        assert blocks["wo"] == {qkey: (None, "model", None), "s": (None, None)}


def _heads(w, cfg):
    """Split a fused ``[q | k | v]`` last axis into its q, k and v heads."""
    d, hq, hkv = cfg.head_dim, cfg.q_heads, cfg.kv_heads
    q = w[..., : hq * d].reshape(*w.shape[:-1], hq, d)
    k = w[..., hq * d: (hq + hkv) * d].reshape(*w.shape[:-1], hkv, d)
    v = w[..., (hq + hkv) * d:].reshape(*w.shape[:-1], hkv, d)
    return q, k, v


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_wqkv_cut_gives_each_rank_its_heads(quant):
    _jp, tp = _tiny_trees("qwen", quant)
    cfg = TPRESETS["tiny"].talker
    mp = 2
    whole = tp["talker"]["blocks"]["wqkv"]
    specs = sharding.param_specs_for(tp)
    for r in range(mp):
        local = sharding.shard_params(FakeMesh(mp, r), tp, specs, cfg)["talker"]["blocks"]["wqkv"]
        lcfg = dataclasses.replace(cfg, q_heads=cfg.q_heads // mp, kv_heads=cfg.kv_heads // mp)
        leaves = [("w", whole, local)] if quant is None else [
            (k, whole[k], local[k]) for k in whole]
        for name, w, lw in leaves:
            wq, wk, wv = _heads(w, cfg)
            lq, lk, lv = _heads(lw, lcfg)
            hq, hkv = cfg.q_heads // mp, cfg.kv_heads // mp
            assert torch.equal(lq, wq[..., r * hq:(r + 1) * hq, :]), name
            assert torch.equal(lk, wk[..., r * hkv:(r + 1) * hkv, :]), name
            assert torch.equal(lv, wv[..., r * hkv:(r + 1) * hkv, :]), name


@pytest.mark.parametrize("mp", [2, 4])
def test_int4_row_shards_repack_their_own_k_range(mp):
    """A row-parallel int4 leaf: each rank's packed shard unpacks to its
    contiguous K rows of the whole weight, and the ranks' partial products
    sum to the whole product."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((2, 64, 24)).astype(np.float32))
    q4 = pack_int4(w)
    whole = unpack_int4(q4["q4"])  # (2, 64, 24)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    tree = {"talker": {"blocks": {"w_down": q4}}}
    specs = {"talker": {"blocks": {"w_down": {"q4": (None, "model", None), "s": (None, None)}}}}
    acc = torch.zeros((2, 3, 24))
    for r in range(mp):
        local = sharding.shard_params(FakeMesh(mp, r), tree, specs)["talker"]["blocks"]["w_down"]
        kl = 64 // mp
        assert local["q4"].shape == (2, kl // 2, 24) and local["q4"].dtype == torch.int8
        assert torch.equal(local["s"], q4["s"])
        assert torch.equal(unpack_int4(local["q4"]), whole[:, r * kl:(r + 1) * kl])
        acc += x[:, r * kl:(r + 1) * kl] @ unpack_int4(local["q4"])
    torch.testing.assert_close(acc, x @ whole, rtol=0, atol=1e-4)


def test_vocab_sharded_embed_is_exact(monkeypatch):
    """Each rank's lookup writes its vocab range and zeros elsewhere; the
    sum over the ranks is the whole table's lookup, bit for bit."""
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.standard_normal((512, 64)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 512, (3, 40)))
    monkeypatch.setattr(collectives, "all_reduce_sum", lambda x, axis: x)
    for mp in (2, 4):
        specs = {"text_embed": ("model", None)}
        parts = []
        for r in range(mp):
            local = sharding.shard_params(FakeMesh(mp, r), {"text_embed": table}, specs)
            assert local["text_embed"].shape == (512 // mp, 64)
            parts.append(collectives.vocab_embed(local["text_embed"], ids,
                                                 mesh.Axis("model", mp, r)))
        assert torch.equal(sum(parts[1:], parts[0]), table[ids])


def test_collectives_over_an_axis_of_one_launch_nothing():
    x = torch.arange(6.0).reshape(2, 3)
    before = collectives.launches
    one = mesh.Axis("model", 1, 0)
    for axis in (None, one):
        assert collectives.all_reduce_sum(x, axis) is x
        assert collectives.all_reduce_max(x, axis) is x
        assert collectives.all_gather(x, 1, axis) is x
    assert collectives.launches == before


@pytest.fixture(scope="module")
def tiny_params():
    from test_torch_port_speculative import fp32_tree

    return from_jax.params_from_numpy(jax.tree.map(np.asarray, fp32_tree("tiny", 0)),
                                      device="cpu")


@pytest.mark.parametrize("mode", ["data", "tensor"])
@pytest.mark.parametrize("quant", [None, "int4"])
def test_world_of_one_codes_equal_unmeshed(world_of_one, tiny_params, mode, quant):
    base = TModel(TPRESETS["tiny"], params=tiny_params, device="cpu", quantization=quant)
    ref = base.generate_codes(TEXTS, speaker="Aria", min_frames=8, max_frames=64,
                              seeds=[1, 2, 3])
    m = TModel(TPRESETS["tiny"], params=tiny_params, device="cpu", quantization=quant)
    before = collectives.launches
    getattr(inference, f"enable_{mode}_parallel")(m, mesh.create_mesh(1, model_parallel=1))
    assert m.mesh.shape == {"data": 1, "model": 1} and m.tp_axis is None
    out = m.generate_codes(TEXTS, speaker="Aria", min_frames=8, max_frames=64, seeds=[1, 2, 3])
    assert collectives.launches == before  # a group of one launches nothing
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)


def test_enable_parallelism_on_a_world_of_one_warns(world_of_one, tiny_params, caplog):
    m = TModel(TPRESETS["tiny"], params=tiny_params, device="cpu")
    with caplog.at_level(logging.WARNING, logger="rho_tts_tpu_torch.parallel.inference"):
        inference.enable_parallelism(m, "tensor")
    assert m.mesh is None and m.tp_axis is None
    assert "only 1 device" in caplog.text
    with pytest.raises(ValueError, match="Unknown parallelism"):
        inference.enable_parallelism(m, "pipeline")


def test_tp_rejects_indivisible_kv_heads(tiny_params):
    m = TModel(TPRESETS["tiny"], params=tiny_params, device="cpu")  # kv_heads=2
    with pytest.raises(ValueError, match="kv_heads"):
        inference.enable_tensor_parallel(m, FakeMesh(4, 0))
    assert m.mesh is None


def test_sp_needs_a_model_axis(world_of_one, tiny_params):
    m = TModel(TPRESETS["tiny"], params=tiny_params, device="cpu")
    with pytest.raises(ValueError, match="model"):
        inference.enable_sequence_parallel(m, mesh.create_mesh(1, model_parallel=1))
    assert not m.seq_parallel


def test_sp_on_chatterbox_raises():
    """Chatterbox's CFG prefill has no sequence-parallel form: SP raises
    instead of running as DP under another name."""
    from rho_tts_tpu_torch.models.chatterbox import PRESETS as CBPRESETS
    from rho_tts_tpu_torch.models.chatterbox import ChatterboxModel

    m = ChatterboxModel(CBPRESETS["tiny"], device="cpu")
    with pytest.raises(ValueError, match="no sequence-parallel prefill"):
        inference.enable_sequence_parallel(m, FakeMesh(2, 0))
    assert m.mesh is None and not hasattr(m, "seq_parallel")


def test_create_mesh_needs_a_process_group_and_a_big_enough_world(world_of_one):
    with pytest.raises(ValueError, match="world of at least 2"):
        mesh.create_mesh(2)
    mesh.shutdown_distributed()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        mesh.create_mesh(1)
    assert not mesh.initialize_distributed()  # no coordinator in the environment


def _save_tp_checkpoint(tiny_params, path, quant, monkeypatch):
    """Rank 0 of a TP model over a model axis of 2 saves its checkpoint, the
    gather emulated in process: rank 1's shards (its model's inputs to
    ``all_gather``, recorded) join rank 0's. Returns rank 0's model, the
    unsharded model's flat params and the saved ones."""
    from rho_tts_tpu_torch.models import checkpoint as ckpt

    def tp_model(index):
        m = TModel(TPRESETS["tiny"], params=tiny_params, device="cpu", quantization=quant)
        inference.enable_tensor_parallel(m, FakeMesh(2, index))
        return m

    whole = ckpt.flatten(TModel(TPRESETS["tiny"], params=tiny_params, device="cpu",
                                quantization=quant).params)
    m, other = tp_model(0), tp_model(1)
    recorded = []
    monkeypatch.setattr(sharding, "all_gather",
                        lambda x, dim, axis: recorded.append(x) or torch.cat([x, x], dim))
    sharding.whole_params(other)
    parts = iter(recorded)
    monkeypatch.setattr(sharding, "all_gather",
                        lambda x, dim, axis: torch.cat([x, next(parts)], dim))
    m.save_checkpoint(path)
    saved, manifest = ckpt.load_params(path, family="qwen", device="cpu")
    assert manifest["quantization"] == quant
    return m, whole, ckpt.flatten(saved)


def test_tensor_parallel_model_refuses_to_save_its_shards(tiny_params, tmp_path, monkeypatch):
    """A TP model holds this rank's shards (here rank 0's cut of a model
    axis of 2: its heads, its ffn columns, half the text vocab); saving
    them as they are would write a partial tree, so ``save_checkpoint``
    gathers them and writes the whole tree, the unsharded model's params bit
    for bit (in process, :func:`_save_tp_checkpoint`; real worlds:
    ``test_torch_port_train_sharded.py``)."""
    m, whole, saved = _save_tp_checkpoint(tiny_params, str(tmp_path / "ckpt"), None, monkeypatch)
    cfg = TPRESETS["tiny"].talker
    assert m.params["talker"]["blocks"]["wqkv"].shape[-1] == (cfg.q_heads + 2 * cfg.kv_heads) \
        * cfg.head_dim // 2
    assert m.params["text_embed"].shape[0] == TPRESETS["tiny"].text_vocab // 2
    assert dict(m.named_parameters())["text_embed"] is m.params["text_embed"]  # re-registered
    assert list(saved) == list(whole) and all(torch.equal(saved[k], whole[k]) for k in whole)


def test_tensor_parallel_int4_checkpoint_packs_row_shards_whole(tiny_params, tmp_path,
                                                                monkeypatch):
    """An int4 TP model's row-parallel shards (``wo``, ``w_down``) hold their
    K rows repacked in halves of their own; the saved checkpoint packs the
    whole K again, as ``pack_int4`` packed it: bit for bit."""
    m, whole, saved = _save_tp_checkpoint(tiny_params, str(tmp_path / "ckpt"), "int4",
                                          monkeypatch)
    cfg = TPRESETS["tiny"].talker
    assert m.params["talker"]["blocks"]["wo"]["q4"].shape[-2] == cfg.q_heads * cfg.head_dim // 4
    assert list(saved) == list(whole) and all(torch.equal(saved[k], whole[k]) for k in whole)


def test_shard_batch_gives_each_data_rank_its_rows():
    rows = torch.arange(24).reshape(6, 4)
    tree = {"a": rows, "b": [rows[:, :1]]}
    parts = [inference.shard_batch(tree, FakeMesh(1, 0, data=3, data_index=d)) for d in range(3)]
    assert torch.equal(torch.cat([p["a"] for p in parts]), rows)
    assert torch.equal(torch.cat([p["b"][0] for p in parts]), rows[:, :1])
    assert sharding.batch_sharding(None, 3) == ("data", None, None)


def test_param_shardings_cover_every_leaf_as_jax():
    jp, tp = _tiny_trees("qwen", "int8")
    jmap = jsharding.param_shardings(jmesh.create_mesh(8, model_parallel=2), jp,
                                     jsharding.qwen_param_specs(jp))
    ours = sharding.param_shardings(FakeMesh(2, 0), tp, sharding.qwen_param_specs(tp))
    assert ours == {k: tuple(v.spec) for k, v in jmap.items()}
    partial = sharding.param_shardings(FakeMesh(2, 0), tp, {"text_embed": ("model", None)})
    assert partial["text_embed"] == ("model", None) and partial["lm_head"] == ()
