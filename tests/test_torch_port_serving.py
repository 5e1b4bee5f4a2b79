"""Port parity of the continuous-batching ServingEngine (``serving.py``).

The scenarios of ``tests/test_serving.py`` (all but the mesh ones, ROADMAP
queue 1 item 12) run through the JAX package's engine and the port's on
the ``tiny`` preset with the same fp32 weights (``from_jax``). The ring
cache, per-row EOS floors, lagged harvest and seeded sampling make served
codes a pure function of each request, so the port's codes must equal the
JAX engine's token for token, greedy and sampled, and its waveforms agree
within 1e-4 (fp32 network and vocoder). The JAX prefill runs its Pallas
kernel in interpret mode, the attention the port's prefill reproduces.
"""

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from rho_tts_tpu.serving import ServingEngine as JEngine
from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel as TModel
from rho_tts_tpu_torch.parallel import inference, mesh
from rho_tts_tpu_torch.serving import ServingEngine as TEngine
from test_torch_port_parallel import world_of_one  # noqa: F401 — fixture
from test_torch_port_parallel_ranks import within
from test_torch_port_speculative import fp32_tree, model_pair

torch.set_num_threads(1)  # several test workers share the cores

TEXTS = [
    "hello world",
    "a second, longer request in another slot",
    "third request joins later",
    "the fourth one rides a recycled slot",
    "five makes the queue deeper than the slot count",
]
WAV_TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    saved = os.environ.get("RHO_TTS_TPU_FUSED_ATTENTION")
    os.environ["RHO_TTS_TPU_FUSED_ATTENTION"] = "1"  # read at trace time
    jax.clear_caches()
    yield model_pair("tiny", fp32_tree("tiny", 0))
    if saved is None:
        del os.environ["RHO_TTS_TPU_FUSED_ATTENTION"]
    else:
        os.environ["RHO_TTS_TPU_FUSED_ATTENTION"] = saved
    jax.clear_caches()


def both(pair, scenario):
    """``scenario(Engine, model)`` through the JAX engine, then the port's:
    returns ``(jax_out, port_out)``."""
    jm, tm = pair
    return scenario(JEngine, jm), scenario(TEngine, tm)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same_requests(ref, ours, waves=True):
    """Codes equal token for token; frame counts equal; waveforms 1e-4."""
    assert len(ref) == len(ours)
    for r, o in zip(ref, ours):
        assert o.done() and r.done() and o.n_frames == r.n_frames
        np.testing.assert_array_equal(o.codes, r.codes)
        if waves:
            rw, rsr = r.result(timeout=5)
            ow, osr = o.result(timeout=5)
            assert isinstance(ow, torch.Tensor) and ow.dtype == torch.float32 and osr == rsr
            assert ow.shape == (o.n_frames * 8,)  # tiny's hop
            np.testing.assert_allclose(ow.numpy(), _np(rw), atol=WAV_TOL, rtol=0)


class TestGreedyParity:
    def test_single_request_matches_jax_and_oneshot(self, pair):
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=128, top_k=1)
            req = eng.submit(TEXTS[0], min_frames=8, max_frames=96)
            eng.run_until_idle()
            return [req]

        ref, ours = both(pair, run)
        assert_same_requests(ref, ours)
        one = pair[1].generate_codes([TEXTS[0]], min_frames=8, max_frames=96,
                                     temperature=1.0, top_k=1)[0]
        n = min(len(one), ours[0].n_frames)
        assert ours[0].n_frames >= 8
        np.testing.assert_array_equal(ours[0].codes[:n], one[:n])

    def test_concurrent_and_queued_requests_all_match(self, pair):
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=128, top_k=1)
            reqs = [eng.submit(t, min_frames=8, max_frames=96) for t in TEXTS]
            eng.run_until_idle()
            return reqs

        assert_same_requests(*both(pair, run))

    def test_ring_wrap_parity(self, pair):
        """One slot, several requests: the global column wraps the ring."""
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=64, top_k=1)
            assert eng.ring == 64 + 64 + eng.chunk
            reqs = [eng.submit(t, min_frames=16, max_frames=64) for t in TEXTS[:4]]
            eng.run_until_idle()
            assert eng._col != 0
            return reqs

        assert_same_requests(*both(pair, run), waves=False)

    def test_late_submission_joins_running_batch(self, pair):
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=128, top_k=1)
            first = eng.submit(TEXTS[0], min_frames=48, max_frames=96)
            eng.step()  # admit + first chunk
            late = eng.submit(TEXTS[2], min_frames=8, max_frames=96)
            eng.run_until_idle()
            assert late.t_admit > first.t_admit
            return [first, late]

        assert_same_requests(*both(pair, run), waves=False)


class TestSampledParity:
    def test_sampled_matches_jax_and_oneshot_with_seed(self, pair):
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=128, top_k=4)
            reqs = [eng.submit(t, min_frames=8, max_frames=96, seed=100 + i, temperature=1.0)
                    for i, t in enumerate(TEXTS[:3])]
            eng.run_until_idle()
            return reqs

        ref, ours = both(pair, run)
        assert_same_requests(ref, ours)
        one = pair[1].generate_codes([TEXTS[2]], min_frames=8, max_frames=96,
                                     temperature=1.0, top_k=4, seeds=[102])[0]
        n = min(len(one), ours[2].n_frames)
        np.testing.assert_array_equal(ours[2].codes[:n], one[:n])

    def test_sampled_schedule_independent(self, pair):
        """The same (text, seed) alone in a 1-slot engine or sharing a 2-slot
        batch: identical codes, in both packages."""
        def run(E, m):
            solo_eng = E(m, n_slots=1, max_prompt=64, max_frames=128, top_k=4)
            solo = solo_eng.submit(TEXTS[1], min_frames=8, max_frames=96, seed=7)
            solo_eng.run_until_idle()
            eng = E(m, n_slots=2, max_prompt=64, max_frames=128, top_k=4)
            filler = eng.submit(TEXTS[3], min_frames=32, max_frames=96, seed=11)
            eng.step()  # the filler occupies slot 0 first
            shared = eng.submit(TEXTS[1], min_frames=8, max_frames=96, seed=7)
            eng.run_until_idle()
            np.testing.assert_array_equal(shared.codes, solo.codes)
            return [solo, filler, shared]

        assert_same_requests(*both(pair, run), waves=False)

    def test_default_seeds_unique_per_submission(self, pair):
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=64, top_k=4)
            a = eng.submit(TEXTS[0], min_frames=32, max_frames=64)
            b = eng.submit(TEXTS[0], min_frames=32, max_frames=64)
            eng.run_until_idle()
            assert a.seed != b.seed
            c = eng.submit(TEXTS[0], min_frames=32, max_frames=64, seed=a.seed)
            eng.run_until_idle()
            np.testing.assert_array_equal(c.codes, a.codes)
            return [a, b, c]

        ref, ours = both(pair, run)
        assert [r.seed for r in ours] == [r.seed for r in ref]
        assert_same_requests(ref, ours, waves=False)


def _collect(req, pieces):
    t = threading.Thread(target=lambda: pieces.extend(p for p, _sr in req.chunks(timeout=300)),
                         daemon=True)
    t.start()
    return t


class TestStreamingServing:
    def test_stream_pieces_match_result(self, pair):
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=128, top_k=1)
            plain = eng.submit(TEXTS[0], min_frames=96, max_frames=96)
            streamed = eng.submit(TEXTS[0], min_frames=96, max_frames=96, stream=True)
            pieces = []
            t = _collect(streamed, pieces)
            eng.run_until_idle()
            within(t.join, 30)
            assert len(pieces) >= 2 and streamed.t_first_audio is not None
            wav_stream = np.concatenate([_np(p) for p in pieces])
            wav_plain = _np(plain.result(timeout=5)[0])
            np.testing.assert_array_equal(streamed.codes, plain.codes)
            assert wav_stream.shape == wav_plain.shape
            np.testing.assert_allclose(wav_stream, wav_plain, atol=2e-2)
            np.testing.assert_array_equal(_np(streamed.result(timeout=5)[0]), wav_stream)
            return [plain, streamed], [_np(p) for p in pieces]

        (ref, ref_pieces), (ours, pieces) = both(pair, run)
        assert_same_requests(ref, ours)
        assert [p.shape for p in pieces] == [p.shape for p in ref_pieces]
        for o, r in zip(pieces, ref_pieces):
            np.testing.assert_allclose(o, r, atol=WAV_TOL, rtol=0)

    def test_stream_early_eos(self, pair):
        """Sampled over the whole vocabulary, this seed draws EOS at frame 55."""
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=128, top_k=67)
            req = eng.submit(TEXTS[2], min_frames=0, max_frames=96, stream=True, seed=4,
                             temperature=1.0)
            eng.run_until_idle()
            total = sum(p.shape[0] for p, _sr in req.chunks(timeout=60))
            assert total == req.n_frames * m.config.codec.hop
            return [req]

        ref, ours = both(pair, run)
        assert ours[0].n_frames == 55  # EOS came first
        assert_same_requests(ref, ours)

    def test_stream_cancel_ends_iterator(self, pair):
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=128, top_k=1)
            req = eng.submit(TEXTS[0], min_frames=128, max_frames=128, stream=True)
            eng.step()
            req.cancel()
            eng.run_until_idle()
            with pytest.raises(RuntimeError):
                list(req.chunks(timeout=60))
            return req.done()

        assert both(pair, run) == (True, True)

    def test_chunks_requires_stream_flag(self, pair):
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=64, top_k=1)
            req = eng.submit(TEXTS[0], max_frames=64)
            eng.run_until_idle()
            with pytest.raises(ValueError, match="stream=True"):
                next(req.chunks())
            return [req]

        assert_same_requests(*both(pair, run), waves=False)


class TestSchedulerBehavior:
    def test_min_frames_floor(self, pair):
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=128, top_k=1)
            req = eng.submit(TEXTS[0], min_frames=40, max_frames=96)
            eng.run_until_idle()
            assert req.n_frames >= 40
            return [req]

        assert_same_requests(*both(pair, run), waves=False)

    def test_cancel_queued_and_active(self, pair):
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=128, top_k=1)
            active = eng.submit(TEXTS[0], min_frames=64, max_frames=128)
            queued = eng.submit(TEXTS[1], min_frames=8, max_frames=64)
            queued.cancel()
            eng.step()
            active.cancel()
            eng.run_until_idle()
            for r in (active, queued):
                assert r.done() and r.cancelled
                with pytest.raises(RuntimeError):
                    r.result(timeout=1)
            return eng.requests_done

        assert both(pair, run) == (0, 0)

    def test_prompt_too_long_rejected(self, pair):
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=64, top_k=1)
            req = eng.submit("word " * 400, max_frames=64)
            eng.run_until_idle()
            assert req.done()
            with pytest.raises(ValueError, match="max_prompt"):
                req.result(timeout=1)
            return str(req.error)

        ref, ours = both(pair, run)
        assert ours == ref

    def test_background_thread(self, pair):
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=128, top_k=1)
            eng.start()
            try:
                reqs = [eng.submit(t, min_frames=8, max_frames=64) for t in TEXTS[:3]]
                for r in reqs:
                    wav, _sr = r.result(timeout=120)
                    assert wav.shape[0] > 0
            finally:
                eng.stop()
            stats = eng.stats()
            assert stats["requests_done"] == 3 and stats["frames_delivered"] >= 3 * 8
            return reqs

        assert_same_requests(*both(pair, run))

    def test_stats_account_delivered_audio(self, pair):
        def run(E, m):
            eng = E(m, n_slots=2, max_prompt=64, max_frames=64, top_k=1)
            reqs = [eng.submit(t, min_frames=8, max_frames=64) for t in TEXTS[:2]]
            eng.run_until_idle()
            stats = eng.stats()
            assert stats["frames_delivered"] == sum(r.n_frames for r in reqs)
            assert stats["aggregate_rtf"] > 0
            assert reqs[0].t_first_audio is None  # non-streaming never vocodes early
            return {k: stats[k] for k in ("requests_done", "frames_decoded", "frames_delivered")}

        ref, ours = both(pair, run)
        assert ours == ref

    def test_backpressure_queue_limit(self, pair):
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=64, top_k=1, max_queue=2)
            eng.submit(TEXTS[0], max_frames=64)
            eng.submit(TEXTS[1], max_frames=64)
            with pytest.raises(RuntimeError, match="queue full"):
                eng.submit(TEXTS[2], max_frames=64)
            eng.run_until_idle()
            return eng.requests_done

        assert both(pair, run) == (2, 2)

    def test_close_fails_outstanding_requests(self, pair):
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=128, top_k=1)
            active = eng.submit(TEXTS[0], min_frames=128, max_frames=128)
            queued = eng.submit(TEXTS[1], max_frames=64, stream=True)
            eng.step()
            eng.close()
            for r in (active, queued):
                assert r.done()
                with pytest.raises(RuntimeError, match="closed"):
                    r.result(timeout=1)
            with pytest.raises(RuntimeError, match="closed"):
                list(queued.chunks(timeout=1))
            return eng._cache_k is None

        assert both(pair, run) == (True, True)

    def test_model_with_a_mesh_raises(self, pair, world_of_one):
        """A model on a mesh serves over it (no raise any more): over meshes
        of one (a gloo world of one) the data- and tensor-parallel engines
        serve the unmeshed engine's codes and waveforms; speculative serving
        over a mesh still raises, as the JAX engine's does. Worlds of 2 and
        4 ranks are ``test_torch_port_parallel_serving.py``."""
        tm = pair[1]

        def serve(m):
            eng = TEngine(m, n_slots=2, max_prompt=64, max_frames=128, top_k=1)
            reqs = [eng.submit(t, min_frames=8, max_frames=96, stream=(i == 1))
                    for i, t in enumerate(TEXTS[:3])]
            eng.run_until_idle()
            return reqs

        ref = serve(tm)
        for mode in ("data", "tensor"):
            m = TModel(tm.config, params=tm.params, device="cpu")
            getattr(inference, f"enable_{mode}_parallel")(m, mesh.create_mesh(1, model_parallel=1))
            assert_same_requests(ref, serve(m))
            with pytest.raises(NotImplementedError, match="device mesh"):
                TEngine(m, n_slots=2, draft_model=TModel(tm.config, params=tm.params,
                                                         device="cpu"))


class TestQoS:
    def test_priority_admits_first(self, pair):
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=64, top_k=1)
            lo1 = eng.submit(TEXTS[0], min_frames=64, max_frames=64)
            eng.step()  # lo1 holds the only slot
            lo2 = eng.submit(TEXTS[1], max_frames=64, priority=0)
            hi = eng.submit(TEXTS[2], max_frames=64, priority=5)
            eng.run_until_idle()
            assert hi.t_admit < lo2.t_admit and lo1.t_admit < hi.t_admit
            return [lo1, lo2, hi]

        assert_same_requests(*both(pair, run), waves=False)

    def test_fifo_within_priority(self, pair):
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=64, top_k=1)
            a = eng.submit(TEXTS[0], max_frames=64, priority=1)
            b = eng.submit(TEXTS[1], max_frames=64, priority=1)
            eng.run_until_idle()
            assert a.t_admit <= b.t_admit
            return [a, b]

        assert_same_requests(*both(pair, run), waves=False)

    def test_expired_queued_request_sheds(self, pair):
        def run(E, m):
            eng = E(m, n_slots=1, max_prompt=64, max_frames=128, top_k=1)
            active = eng.submit(TEXTS[0], min_frames=64, max_frames=128)
            doomed = eng.submit(TEXTS[1], max_frames=64, expires_s=0.0)
            time.sleep(0.01)
            eng.run_until_idle()
            assert doomed.done()
            with pytest.raises(TimeoutError):
                doomed.result(timeout=1)
            return [active]

        assert_same_requests(*both(pair, run), waves=False)
