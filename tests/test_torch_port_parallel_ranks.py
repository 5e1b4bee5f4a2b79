"""Port parity of the one-shot Qwen path over spawned worlds of 2 and 4 ranks.

Each world is a set of gloo processes on the CPU (``torch.multiprocessing``
with the ``spawn`` start method, ``file://`` init under ``tmp_path``, one
intra-op thread per rank): the port's SPMD execution model, every rank
making the same calls and returning the whole result. One spawn per world
size runs every scenario and returns their results through files; the
JAX package runs the same scenarios on its 8 virtual CPU devices
(``tests/conftest.py``) over the same fp32 ``tiny`` weights, its prefill
through the Pallas kernel in interpret mode.

* DP ``(2, 1)``: a batch of 3 (padded to 4 and trimmed) decodes the codes
  of JAX's DP mesh and of the unmeshed model, exactly.
* TP ``(1, 2)`` and ``(2, 2)``, dense, int8, int4 and w8a8 prefill: the
  prefill logits within 1e-4 of JAX's TP mesh, greedy codes equal.
* SP ``(1, 2)`` and ``(2, 2)``: codes equal JAX's SP mesh and the unmeshed
  model's; ``sp_fused_gqa_attention`` equals the plain attention within
  2e-5 on the rows that have a valid key, and JAX's wrapper.

The port's tests bound every wait through this module's two helpers:
:func:`start_world` (with :class:`World` and the :func:`reap_worlds`
fixture) for child processes and :func:`within` for a call that could
block. This module imports no JAX at the top: the ranks import it to find
their functions.
"""

import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # several test workers share the cores

TEXTS = ["mesh parity check", "a second, longer row of text", "three"]
SEEDS = [11, 12, 13]
SAMPLED = dict(speaker="Aria", min_frames=8, max_frames=64, seeds=SEEDS)
GREEDY = dict(SAMPLED, top_k=1)
QUANTS = [None, "int8", "int4", "w8a8"]
LOGIT_TOL = 1e-4
WORLD_TIMEOUT_S = 300  # a world that hangs fails here, not at the suite's clock


# ---------------------------------------------------------------------------
# The bounded-wait helpers
# ---------------------------------------------------------------------------

REAP_S = 30  # a killed child is reaped within this


def within(fn, timeout: float, on_timeout=None):
    """``fn()`` on a daemon thread, its result or its exception. Past
    ``timeout`` s, ``on_timeout()`` runs (it kills what ``fn`` waits on) and
    the test fails naming ``fn``: a call that blocks fails here, not at the
    suite's clock."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e

    th = threading.Thread(target=run, daemon=True, name="within")
    th.start()
    th.join(timeout)
    if th.is_alive():
        if on_timeout is not None:
            on_timeout()
        pytest.fail(f"{getattr(fn, '__qualname__', fn)} ran past {timeout} s")
    if "err" in box:
        raise box["err"]
    return box.get("out")


def _rank_main(rank, n, tmp, fn, args):
    """One rank: the process group, ``fn(rank, n, *args)``, its result to a file."""
    torch.set_num_threads(1)
    from rho_tts_tpu_torch.parallel import mesh

    # A stuck collective raises in its rank, well inside the world's limit.
    mesh.initialize_distributed(f"file://{tmp}/pg", n, rank, device="cpu", timeout_s=120)
    out = fn(rank, n, *args)
    torch.save(out, f"{tmp}/rank{rank}.pt")
    mesh.shutdown_distributed()


#: worlds started and not yet joined; :func:`reap_worlds` kills what is left
_LIVE_WORLDS = []


class World:
    """A spawned gloo world running ``fn`` in every rank (see :func:`start_world`)."""

    def __init__(self, tmp: Path, n: int, fn, args, timeout: float):
        import torch.multiprocessing as mp

        self.tmp, self.n, self.timeout = tmp, n, timeout
        tmp.mkdir(parents=True, exist_ok=True)
        self.t0 = time.monotonic()
        saved = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"  # the ranks inherit one OpenMP thread
        try:
            self.ctx = mp.start_processes(_rank_main, args=(n, str(tmp), fn, args), nprocs=n,
                                          join=False, start_method="spawn")
        finally:
            if saved is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = saved
        _LIVE_WORLDS.append(self)

    def kill(self) -> bool:
        """Kill and reap every rank; True when one was still running."""
        alive = [p for p in self.ctx.processes if p.is_alive()]
        for p in alive:
            p.kill()
        for p in self.ctx.processes:
            p.join(REAP_S)
        return bool(alive)

    def join(self):
        """Each rank's result, in rank order. A rank that raised or died
        fails with its traceback; a world past its time limit is killed."""
        try:
            while not self.ctx.join(timeout=1.0):
                if time.monotonic() - self.t0 > self.timeout:
                    raise TimeoutError(
                        f"a world of {self.n} ranks ran past {self.timeout} s")
        finally:
            self.kill()
            _LIVE_WORLDS.remove(self)
        return [torch.load(self.tmp / f"rank{r}.pt", weights_only=False)
                for r in range(self.n)]


def start_world(tmp_path: Path, n: int, fn, *args, timeout: float) -> World:
    """Start ``n`` gloo ranks, each running ``fn(rank, n, *args)`` (a
    module-level function) after its process group is up; collect with
    :meth:`World.join`. The parent is free meanwhile (the JAX side runs
    there). ``timeout`` bounds the world (``WORLD_TIMEOUT_S`` as a rule); a
    module that starts worlds imports :func:`reap_worlds`."""
    return World(Path(tmp_path), n, fn, args, timeout)


@pytest.fixture(scope="module", autouse=True)
def reap_worlds():
    """No rank outlives its test module: a world still running at the
    module's end (its join never reached) is killed, and the module fails."""
    yield
    left = [w for w in list(_LIVE_WORLDS) if w.kill()]
    _LIVE_WORLDS.clear()
    assert not left, f"{len(left)} world(s) still running at the module's end, killed"


def test_within_fails_a_blocked_call_and_passes_the_rest_through():
    release = threading.Event()
    with pytest.raises(pytest.fail.Exception, match=r"Event\.wait ran past 0\.2 s"):
        within(release.wait, 0.2, on_timeout=release.set)
    assert release.is_set()  # on_timeout ran: what the call waited on was released
    assert within(lambda: 3, 5) == 3

    def boom():
        raise ValueError("raised in the thread")

    with pytest.raises(ValueError, match="raised in the thread"):
        within(boom, 5)


def _assert_same_tree(a, b, msg):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), msg
        for x, y in zip(a, b):
            _assert_same_tree(x, y, msg)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def assert_ranks_agree(results, key):
    """Every rank returned the same whole result under ``key``."""
    for r, res in enumerate(results[1:], 1):
        _assert_same_tree(results[0][key], res[key], f"rank {r}, {key}")


# ---------------------------------------------------------------------------
# The port's side (runs in every rank)
# ---------------------------------------------------------------------------


def _w8a8(quant):
    """``RHO_TTS_TPU_W8A8_PREFILL`` for the w8a8 case (read at call time)."""
    if quant == "w8a8":
        os.environ["RHO_TTS_TPU_W8A8_PREFILL"] = "1"
    else:
        os.environ.pop("RHO_TTS_TPU_W8A8_PREFILL", None)
    return "int8" if quant == "w8a8" else quant


def qwen_world(rank, n, tree, attn_inputs):
    from rho_tts_tpu_torch import from_jax
    from rho_tts_tpu_torch.models.qwen import PRESETS
    from rho_tts_tpu_torch.models.qwen import model as qm
    from rho_tts_tpu_torch.ops.cuda.attention import sp_fused_gqa_attention
    from rho_tts_tpu_torch.parallel import collectives, inference, mesh

    params = from_jax.params_from_numpy(tree, device="cpu")

    def model(quant=None):
        return qm.QwenTTSModel(PRESETS["tiny"], params=params, device="cpu", quantization=quant)

    out = {"ref": model().generate_codes(TEXTS, **SAMPLED)}
    if n == 2:
        m = model()
        inference.enable_data_parallel(m, mesh.create_mesh(2, model_parallel=1))
        out["dp"] = m.generate_codes(TEXTS, **SAMPLED)

    logits = []
    orig = qm._prefill

    def spy(*a, **k):
        res = orig(*a, **k)
        logits.append(res[0].clone())
        return res

    qm._prefill = spy
    for quant in QUANTS:
        m = model(_w8a8(quant))
        out[f"ref_greedy_{quant}"] = m.generate_codes(TEXTS, **GREEDY)
        inference.enable_tensor_parallel(m, mesh.create_mesh(n, model_parallel=2))
        assert m.tp_axis is not None and m.tp_axis.size == 2
        logits.clear()
        out[f"tp_{quant}"] = m.generate_codes(TEXTS, **GREEDY)
        out[f"tp_logits_{quant}"] = logits[0]  # this rank's data rows
    qm._prefill = orig
    _w8a8(None)

    m = model()
    inference.enable_sequence_parallel(m, mesh.create_mesh(n, model_parallel=2))
    before = collectives.launches
    out["sp"] = m.generate_codes(TEXTS, **SAMPLED)
    out["sp_collectives"] = collectives.launches - before
    out["coords"] = m.mesh.coords

    q, k, v, mask = (torch.from_numpy(a) for a in attn_inputs)
    sp_mesh = mesh.create_mesh(n, model_parallel=2)
    axis = sp_mesh.axis("model")
    tl = q.shape[1] // axis.size
    mine = slice(axis.index * tl, (axis.index + 1) * tl)
    part = sp_fused_gqa_attention(q[:, mine], k[:, mine], v[:, mine], mask[:, mine], axis)
    out["sp_attention"] = collectives.all_gather(part, 1, axis)
    return out


# ---------------------------------------------------------------------------
# The JAX side and the comparisons
# ---------------------------------------------------------------------------


def _attn_inputs():
    """make_inputs of tests/test_pallas_attention.py at (b=2, t=64), valid from 6."""
    rng = np.random.default_rng(0)
    b, t, hq, hkv, d = 2, 64, 4, 2, 16
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    mask = np.broadcast_to(np.arange(t) >= 6, (b, t)).copy()
    return q, k, v, mask


@pytest.fixture(scope="module")
def fused_prefill():
    """The JAX prefill through its Pallas kernel (interpret mode), the
    attention the port's prefill reproduces; read at trace time."""
    import jax

    saved = os.environ.get("RHO_TTS_TPU_FUSED_ATTENTION")
    os.environ["RHO_TTS_TPU_FUSED_ATTENTION"] = "1"
    jax.clear_caches()
    yield
    if saved is None:
        del os.environ["RHO_TTS_TPU_FUSED_ATTENTION"]
    else:
        os.environ["RHO_TTS_TPU_FUSED_ATTENTION"] = saved
    jax.clear_caches()


@pytest.fixture(scope="module")
def tree():
    import jax

    from test_torch_port_speculative import fp32_tree

    return fp32_tree("tiny", 0), jax.tree.map(np.asarray, fp32_tree("tiny", 0))


def jax_run(jtree, n=None, mp=1, mode=None, quant=None, kw=SAMPLED):
    """JAX's codes and prefill logits on a (n/mp, mp) mesh of its devices."""
    import jax

    from rho_tts_tpu.models.qwen import PRESETS
    from rho_tts_tpu.models.qwen import model as jqm
    from rho_tts_tpu.parallel import create_mesh, inference

    if (quant == "w8a8") != (os.environ.get("RHO_TTS_TPU_W8A8_PREFILL") == "1"):
        _w8a8(quant)
        jax.clear_caches()  # JAX reads the flag at trace time
    m = jqm.QwenTTSModel(PRESETS["tiny"], params=jtree,
                         quantization="int8" if quant == "w8a8" else quant)
    if mode is not None:
        getattr(inference, f"enable_{mode}_parallel")(m, create_mesh(n, model_parallel=mp))
    logits = []
    orig = jqm._prefill

    def spy(*a, **k):
        res = orig(*a, **k)
        logits.append(np.asarray(res[0]))
        return res

    jqm._prefill = spy
    try:
        codes = [np.asarray(c) for c in m.generate_codes(TEXTS, **kw)]
    finally:
        jqm._prefill = orig
    return codes, logits[0]


@pytest.fixture(scope="module")
def worlds(tree, fused_prefill, tmp_path_factory):
    """Both worlds' rank results and the JAX references, the JAX side run
    while each world computes."""
    import jax

    jtree, ntree = tree
    attn = _attn_inputs()
    out = {}
    for n in (2, 4):
        world = start_world(tmp_path_factory.mktemp(f"world{n}"), n, qwen_world, ntree, attn,
                            timeout=WORLD_TIMEOUT_S)
        ref = {"unmeshed": jax_run(jtree)[0]}
        if n == 2:
            ref["dp"] = jax_run(jtree, 2, 1, "data")[0]
        for quant in QUANTS:
            ref[f"tp_{quant}"] = jax_run(jtree, n, 2, "tensor", quant, GREEDY)
        _w8a8(None)
        jax.clear_caches()
        ref["sp"] = jax_run(jtree, n, 2, "sequence")[0]
        out[n] = (world.join(), ref)
    return out


def _same_codes(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_dp_codes_equal_jax_mesh_and_unmeshed(worlds):
    """An uneven batch of 3 on a data axis of 2: padded with row 0's copy
    (and seed), decoded, trimmed to 3, codes exact."""
    ranks, ref = worlds[2]
    assert_ranks_agree(ranks, "dp")
    assert len(ranks[0]["dp"]) == 3
    _same_codes(ranks[0]["dp"], ranks[0]["ref"])
    _same_codes(ranks[0]["dp"], ref["dp"])
    _same_codes(ranks[0]["ref"], ref["unmeshed"])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("quant", QUANTS)
def test_tp_prefill_logits_and_greedy_codes_match_jax(worlds, n, quant):
    """TP over a model axis of 2 (meshes (1, 2) and (2, 2)): the ranks'
    prefill logits, assembled over ``data``, within 1e-4 of JAX's TP mesh;
    greedy codes equal JAX's and the unmeshed model's."""
    ranks, ref = worlds[n]
    key = f"tp_{quant}"
    assert_ranks_agree(ranks, key)
    jcodes, jlogits = ref[key]
    _same_codes(ranks[0][key], jcodes)
    _same_codes(ranks[0][key], ranks[0][f"ref_greedy_{quant}"])
    dp = n // 2
    # The ranks of model index 0 hold the data rows in order.
    ours = torch.cat([ranks[2 * d][f"tp_logits_{quant}"] for d in range(dp)]).numpy()
    assert ours.shape == jlogits.shape
    np.testing.assert_allclose(ours, jlogits, atol=LOGIT_TOL, rtol=0)
    for r in range(n):  # the model group's ranks hold the same rows
        np.testing.assert_array_equal(ranks[r][f"tp_logits_{quant}"],
                                      ranks[r - r % 2][f"tp_logits_{quant}"])


@pytest.mark.parametrize("n", [2, 4])
def test_sp_codes_equal_jax_mesh_and_unmeshed(worlds, n):
    ranks, ref = worlds[n]
    assert_ranks_agree(ranks, "sp")
    _same_codes(ranks[0]["sp"], ranks[0]["ref"])
    _same_codes(ranks[0]["sp"], ref["sp"])
    # Per layer a K and a V gather, then the hidden states; DP's codes
    # gather and done flags over data on the (2, 2) mesh.
    assert ranks[0]["sp_collectives"] > 0


@pytest.mark.parametrize("n", [2, 4])
def test_sp_fused_attention_matches_reference_and_jax(worlds, n):
    """The SP wrapper on each rank's query shard at its offset, joined over
    the ranks: equal to the plain attention on the whole sequence within
    2e-5 on the rows that have a valid key (rows before the first valid key
    average by their pad length), and to JAX's ``sp_fused_gqa_attention``."""
    import jax
    from jax.sharding import Mesh

    from rho_tts_tpu.ops.pallas.attention import sp_fused_gqa_attention
    from rho_tts_tpu_torch.ops.cuda.attention import reference_gqa_attention

    ranks, _ = worlds[n]
    q, k, v, mask = _attn_inputs()
    ours = ranks[0]["sp_attention"].numpy()
    ref = reference_gqa_attention(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
    np.testing.assert_allclose(ours[:, 6:], ref[:, 6:], atol=2e-5, rtol=2e-5)
    jmesh = Mesh(np.array(jax.devices()[:n]).reshape(n // 2, 2), ("data", "model"))
    jout = sp_fused_gqa_attention(q, k, v, mask, mesh=jmesh, causal=True, interpret=True)
    np.testing.assert_allclose(ours[:, 6:], np.asarray(jout)[:, 6:], atol=2e-5, rtol=2e-5)


def test_multihost_dryrun_two_processes(monkeypatch):
    """``run_dryrun(2)``: two processes over a coordinator address (gloo
    here), DP decode and the ServingEngine bit-exact against a
    process-local reference, and JAX's pipeline-parallel train step (2
    stages) with the same loss on both processes, its first-step
    gradients and its step within the dry run's bounds of a process-local
    unpipelined step."""
    from rho_tts_tpu_torch.parallel.multihost_dryrun import PP_GRAD_TOL, run_dryrun

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the two processes inherit it
    reports = run_dryrun(2, timeout=WORLD_TIMEOUT_S)
    assert len(reports) == 2 and all(r.startswith("OK") for r in reports)
    assert "serve=OK" in reports[0] and reports[0].split("checksum=")[1] == \
        reports[1].split("checksum=")[1]
    assert all(" pp=OK pp_mesh={'data': 1, 'pipe': 2}" in r for r in reports)
    losses = [r.split("pp_loss=")[1].split()[0] for r in reports]
    assert losses[0] == losses[1]
    assert all(float(r.split("pp_grad_error=")[1].split()[0]) <= PP_GRAD_TOL for r in reports)
