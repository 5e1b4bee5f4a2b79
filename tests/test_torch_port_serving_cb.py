"""Port parity of the Chatterbox serving engine (``serving_cb.py``).

Every scenario of ``tests/test_serving_cb.py`` but the mesh ones (ROADMAP
queue 1 item 12) runs through the JAX package's ``ChatterboxServingEngine``
and the port's, on the ``tiny`` pair of ``test_torch_port_chatterbox``
(same fp32 weights). Each request's CFG pair rides rows (i, i + n_slots)
of the ring; sampling is a pure function of (request seed, frame), so the
port's served tokens equal the JAX engine's token for token, greedy and
sampled, and both equal the one-shot decode of the same seed; waveforms
(vocoder and watermark) agree within 1e-4.
"""

import numpy as np
import pytest
import torch

from rho_tts_tpu.audio_io import save_wav
from rho_tts_tpu.serving_cb import ChatterboxServingEngine as JEngine
from rho_tts_tpu_torch.models.chatterbox import model as tcb
from rho_tts_tpu_torch.ops.watermark import apply_watermark
from rho_tts_tpu_torch.parallel import inference, mesh
from rho_tts_tpu_torch.serving_cb import ChatterboxServingEngine as TEngine
from test_torch_port_parallel import world_of_one  # noqa: F401 — fixture
from test_torch_port_chatterbox import (  # noqa: F401 — fixtures
    cb_fp32_tree,
    cb_pair,
    jax_prefill_kernel,
    tokens,
)

torch.set_num_threads(1)  # several test workers share the cores

TEXTS = [
    "hello world",
    "a second, longer request in another slot",
    "third request joins later",
    "the fourth one rides a recycled slot",
]
WAV_TOL = 1e-4
HOP = tcb.PRESETS["tiny"].codec.hop


@pytest.fixture(scope="module")
def params():
    return cb_fp32_tree(0)


@pytest.fixture(scope="module")
def pair(jax_prefill_kernel, params):  # noqa: F811
    return cb_pair(params)


@pytest.fixture(scope="module")
def greedy(jax_prefill_kernel, params):  # noqa: F811
    return cb_pair(params, top_k=1)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def both(models, scenario):
    """``scenario(Engine, model)`` through the JAX engine, then the port's."""
    jm, tm = models
    return scenario(JEngine, jm), scenario(TEngine, tm)


def assert_same_requests(ref, ours, waves=True):
    """Tokens equal token for token; frame counts equal; waveforms 1e-4."""
    assert len(ref) == len(ours)
    for r, o in zip(ref, ours):
        assert o.done() and r.done() and o.n_frames == r.n_frames
        np.testing.assert_array_equal(o.codes, np.asarray(r.codes))
        if waves:
            rw, _ = r.result(timeout=5)
            ow, osr = o.result(timeout=5)
            assert isinstance(ow, torch.Tensor) and ow.dtype == torch.float32
            assert ow.shape == (o.n_frames * HOP,) and osr == 24000
            np.testing.assert_allclose(ow.numpy(), _np(rw), atol=WAV_TOL, rtol=0)


def oneshot(model, torch_side, text, min_new=0, max_new=96, seed=0, temperature=1.0,
            cfg_weight=0.6, ref_audio=None):
    """The one-shot decode of a request (``tests/test_serving_cb.py``'s
    reference), in either package."""
    return tokens(model, torch_side, text=text, audio_prompt_path=ref_audio,
                  temperature=temperature, cfg_weight=cfg_weight, max_new_tokens=max_new,
                  min_new_tokens=min_new, seeds=[seed])


def assert_prefix(req, ref):
    """Prefix match (the one-shot and served paths round their frame budgets
    differently)."""
    got = req.codes
    n = min(got.shape[0], ref.shape[0])
    assert n > 0
    np.testing.assert_array_equal(got[:n], ref[:n])


class TestGreedyParity:
    def test_single_request_matches_jax_and_oneshot(self, greedy):
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=128, chunk=32)
            req = eng.submit(TEXTS[0], min_frames=8, max_frames=96)
            eng.run_until_idle()
            return [req]

        ref, ours = both(greedy, run)
        assert_same_requests(ref, ours)
        assert ours[0].n_frames >= 8
        assert_prefix(ours[0], oneshot(greedy[1], True, TEXTS[0], min_new=8))

    def test_concurrent_and_recycled_slots(self, greedy):
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=128, chunk=32)
            reqs = [eng.submit(t, min_frames=8, max_frames=96) for t in TEXTS]
            eng.run_until_idle()
            return reqs

        ref, ours = both(greedy, run)
        assert_same_requests(ref, ours)
        for t, req in zip(TEXTS, ours):
            assert_prefix(req, oneshot(greedy[1], True, t, min_new=8))

    def test_ring_wrap_parity(self, greedy):
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=64, chunk=32)
            assert eng.ring == 64 + 64 + eng.chunk
            reqs = [eng.submit(t, min_frames=16, max_frames=64) for t in TEXTS]
            eng.run_until_idle()
            return reqs

        ref, ours = both(greedy, run)
        assert_same_requests(ref, ours)
        for t, req in zip(TEXTS, ours):
            assert_prefix(req, oneshot(greedy[1], True, t, min_new=16, max_new=64))

    def test_waveform_matches_model_vocode(self, greedy):
        """The retired waveform is the model-level vocode + position-0
        watermark of the same tokens."""
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=128, chunk=32)
            req = eng.submit(TEXTS[1], min_frames=8, max_frames=96)
            eng.run_until_idle()
            return [req]

        ref, ours = both(greedy, run)
        assert_same_requests(ref, ours)
        req = ours[0]
        end = req.n_frames
        toks = oneshot(greedy[1], True, TEXTS[1], min_new=8)[:end]
        assert toks.shape[0] == end
        tm = greedy[1]
        raw = tcb._vocode_masked(tm.params, tm.cfg, torch.from_numpy(toks), end,
                                 tcb._round_up(end, 32))[0, : end * HOP]
        np.testing.assert_allclose(req.result(timeout=5)[0].numpy(),
                                   apply_watermark(raw).numpy(), atol=2e-5)


class TestSampledParity:
    def test_sampled_matches_jax_and_oneshot_with_seed(self, pair):
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=128, chunk=32)
            reqs = [eng.submit(t, min_frames=8, max_frames=96, seed=100 + i, temperature=0.9,
                               cfg_weight=0.4) for i, t in enumerate(TEXTS[:3])]
            eng.run_until_idle()
            return reqs

        ref, ours = both(pair, run)
        assert_same_requests(ref, ours)
        for i, (t, req) in enumerate(zip(TEXTS[:3], ours)):
            assert_prefix(req, oneshot(pair[1], True, t, min_new=8, seed=100 + i,
                                       temperature=0.9, cfg_weight=0.4))

    def test_sampled_schedule_independent(self, pair):
        def run(E, m):
            solo_eng = E(m, n_slots=1, max_prompt=64, max_frames=128, chunk=32)
            solo = solo_eng.submit(TEXTS[1], min_frames=8, max_frames=96, seed=7)
            solo_eng.run_until_idle()
            eng = E(m, n_slots=2, max_prompt=64, max_frames=128, chunk=32)
            filler = eng.submit(TEXTS[3], min_frames=32, max_frames=96, seed=11)
            eng.step()  # the filler takes slot 0 first
            shared = eng.submit(TEXTS[1], min_frames=8, max_frames=96, seed=7)
            eng.run_until_idle()
            assert filler.done() and shared.done()
            np.testing.assert_array_equal(shared.codes, np.asarray(solo.codes))
            return [solo, filler, shared]

        ref, ours = both(pair, run)
        assert_same_requests(ref, ours)

    def test_default_seeds_unique_per_submission(self, pair):
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=64, chunk=32)
            a = eng.submit(TEXTS[0], min_frames=32, max_frames=64)
            b = eng.submit(TEXTS[0], min_frames=32, max_frames=64)
            eng.run_until_idle()
            assert a.seed != b.seed
            c = eng.submit(TEXTS[0], min_frames=32, max_frames=64, seed=a.seed)
            eng.run_until_idle()
            np.testing.assert_array_equal(c.codes, np.asarray(a.codes))
            return [a, b, c]

        ref, ours = both(pair, run)
        assert [r.seed for r in ours] == [r.seed for r in ref]
        assert_same_requests(ref, ours)


def _ref_wav(tmp_path, period):
    sr = 24000
    rng = np.random.default_rng(0)
    wav = (0.3 * np.sin(np.arange(sr) / period) + 0.02 * rng.standard_normal(sr)).astype(
        np.float32)
    path = str(tmp_path / f"ref{period}.wav")
    save_wav(path, wav, sr)
    return path


class TestVoiceConditioning:
    def test_ref_audio_parity_and_cache(self, greedy, tmp_path):
        ref_path = _ref_wav(tmp_path, 30)

        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=96, chunk=32)
            r1 = eng.submit(TEXTS[0], ref_audio=ref_path, min_frames=8, max_frames=64)
            r2 = eng.submit(TEXTS[2], ref_audio=ref_path, min_frames=8, max_frames=64)
            eng.run_until_idle()
            assert len(eng._spk_cache) == 1  # the speaker embedding computed once
            return [r1, r2]

        ref, ours = both(greedy, run)
        assert_same_requests(ref, ours)
        assert_prefix(ours[0], oneshot(greedy[1], True, TEXTS[0], min_new=8, max_new=64,
                                       ref_audio=ref_path))

    def test_unconditioned_differs_from_conditioned(self, greedy, tmp_path):
        ref_path = _ref_wav(tmp_path, 17)

        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=96, chunk=32)
            a = eng.submit(TEXTS[0], min_frames=16, max_frames=64)
            b = eng.submit(TEXTS[0], ref_audio=ref_path, min_frames=16, max_frames=64)
            eng.run_until_idle()
            n = min(a.codes.shape[0], b.codes.shape[0])
            assert not np.array_equal(np.asarray(a.codes)[:n], np.asarray(b.codes)[:n])
            return [a, b]

        ref, ours = both(greedy, run)
        assert_same_requests(ref, ours)


class TestStreamingServing:
    def test_stream_pieces_match_nonstream_result(self, greedy):
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=128, chunk=32)
            s = eng.submit(TEXTS[1], min_frames=24, max_frames=96, stream=True, seed=3)
            n = eng.submit(TEXTS[1], min_frames=24, max_frames=96, seed=3)
            eng.start()
            pieces = [_np(p) for p, _sr in s.chunks(timeout=60)]
            eng.stop()
            n.result(timeout=30)
            assert len(pieces) >= 1
            streamed = np.concatenate(pieces)
            wav_n = _np(n.result(timeout=5)[0])
            assert streamed.shape == wav_n.shape
            np.testing.assert_allclose(streamed, wav_n, atol=2e-5)
            return [s, n], pieces

        (ref, ref_pieces), (ours, our_pieces) = both(greedy, run)
        assert_same_requests(ref, ours)
        assert len(our_pieces) == len(ref_pieces)
        for o, r in zip(our_pieces, ref_pieces):
            np.testing.assert_allclose(o, r, atol=WAV_TOL, rtol=0)

    def test_retired_wav_carries_watermark(self, greedy):
        """The retired waveform carries a position-0 watermark of its raw
        vocode: present and offset-aligned (an utterance longer than the
        1024-sample envelope window)."""
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=256, chunk=32)
            req = eng.submit(TEXTS[0], min_frames=240, max_frames=256)
            eng.run_until_idle()
            return [req]

        ref, ours = both(greedy, run)
        assert_same_requests(ref, ours)
        req = ours[0]
        end = req.n_frames
        assert end * HOP >= 2048
        tm = greedy[1]
        raw = tcb._vocode_masked(tm.params, tm.cfg, torch.from_numpy(req.codes), end,
                                 tcb._round_up(end, 32))[0, : end * HOP]
        wav = req.result(timeout=5)[0]
        assert (wav - raw).abs().max().item() > 1e-6  # the watermark is present
        np.testing.assert_allclose(wav.numpy(), apply_watermark(raw).numpy(), atol=2e-5)


class TestSchedulerBehavior:
    def test_min_frames_floor(self, pair):
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=96, chunk=32)
            req = eng.submit(TEXTS[0], min_frames=40, max_frames=96)
            eng.run_until_idle()
            assert req.n_frames >= 40
            return [req]

        assert_same_requests(*both(pair, run))

    def test_cancel_queued_and_active(self, pair):
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=96, chunk=32)
            active = eng.submit(TEXTS[0], min_frames=64, max_frames=96)
            queued = eng.submit(TEXTS[1], min_frames=8, max_frames=96)
            eng.step()
            active.cancel()
            queued.cancel()
            eng.run_until_idle()
            for req in (active, queued):
                assert req.cancelled
                with pytest.raises(RuntimeError):
                    req.result(timeout=1)
            return eng.stats()

        ref, ours = both(pair, run)
        assert ours["requests_done"] == ref["requests_done"] == 0

    def test_prompt_too_long_rejected(self, pair):
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=64, chunk=32)
            req = eng.submit("word " * 200, min_frames=8)
            eng.run_until_idle()
            with pytest.raises(ValueError, match="max_prompt"):
                req.result(timeout=1)
            return str(req.error)

        ref, ours = both(pair, run)
        assert ours == ref

    def test_stats_account_delivered_audio(self, pair):
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=64, chunk=32)
            reqs = [eng.submit(t, min_frames=16, max_frames=64) for t in TEXTS[:2]]
            eng.run_until_idle()
            st = eng.stats()
            assert st["requests_done"] == 2
            assert st["frames_delivered"] == sum(r.n_frames for r in reqs)
            return reqs, st

        (ref, rst), (ours, ost) = both(pair, run)
        assert_same_requests(ref, ours)
        assert ost["frames_delivered"] == rst["frames_delivered"]
        assert ost["frames_decoded"] == rst["frames_decoded"]


def test_mesh_model_raises(pair, world_of_one):
    """A model on a mesh serves over it (no raise any more): over meshes of
    one (a gloo world of one) the data- and tensor-parallel CFG-pair
    engines serve the unmeshed engine's tokens and waveforms. Worlds of 2
    and 4 ranks are ``test_torch_port_parallel_serving.py``."""
    _jm, tm = pair

    def serve(m):
        eng = TEngine(m, n_slots=2, max_prompt=64, max_frames=128, chunk=32)
        reqs = [eng.submit(t, min_frames=8, max_frames=96, seed=i, stream=(i == 1))
                for i, t in enumerate(["one", "a second request", "three"])]
        eng.run_until_idle()
        return reqs

    ref = serve(tm)
    for mode in ("data", "tensor"):
        m = tcb.ChatterboxModel(tm.cfg, params=tm.params, device="cpu")
        getattr(inference, f"enable_{mode}_parallel")(m, mesh.create_mesh(1, model_parallel=1))
        assert_same_requests(ref, serve(m))
