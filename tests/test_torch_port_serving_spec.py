"""Port parity of speculative serving (``serving_spec``) inside the ServingEngine.

The scenarios of ``tests/test_serving_spec.py`` run through the JAX
package's engine and the port's on the ``tiny`` target with an unrelated
draft (the ``draft`` preset: low acceptance, rows desynchronize) and an
identical one (the target's weights: p == q), the same fp32 weights in
both packages (``from_jax``), in both residual modes. Draws come from the
same ``(seed, frame, tag)`` threefry keys, so the codes, the rounds
dispatched (``spec_rounds``) and each row's rewound write column
(``_spec_cols``) must be equal; waveforms agree within 1e-4.
"""

import os

import jax
import numpy as np
import pytest
import torch

from rho_tts_tpu.serving import ServingEngine as JEngine
from rho_tts_tpu_torch.serving import ServingEngine as TEngine
from test_torch_port_serving import assert_same_requests
from test_torch_port_speculative import fp32_tree, model_pair

torch.set_num_threads(1)  # several test workers share the cores

TEXTS = [
    "hello speculative world",
    "a second, longer request in another slot",
    "third request joins later",
    "the fourth one rides a recycled slot",
]
MODES = ["strict", "draft"]


@pytest.fixture(scope="module")
def models():
    saved = os.environ.get("RHO_TTS_TPU_FUSED_ATTENTION")
    os.environ["RHO_TTS_TPU_FUSED_ATTENTION"] = "1"  # read at trace time
    jax.clear_caches()
    tree = fp32_tree("tiny", 0)
    yield {"target": model_pair("tiny", tree), "same": model_pair("tiny", tree),
           "other": model_pair("draft", fp32_tree("draft", 123))}
    if saved is None:
        del os.environ["RHO_TTS_TPU_FUSED_ATTENTION"]
    else:
        os.environ["RHO_TTS_TPU_FUSED_ATTENTION"] = saved
    jax.clear_caches()


def both(models, draft, scenario, **engine_kw):
    """``scenario(engine)`` on a fresh JAX engine and a fresh port engine over
    the target and ``draft`` ("same" / "other"); returns both outputs and
    checks that the engines dispatched the same rounds and ended with the
    same per-row columns."""
    outs = []
    for i, Engine in enumerate((JEngine, TEngine)):
        eng = Engine(models["target"][i], draft_model=models[draft][i], **engine_kw)
        outs.append((scenario(eng), eng))
    (ref, jeng), (ours, teng) = outs
    assert teng.spec_rounds == jeng.spec_rounds and teng.ring == jeng.ring
    np.testing.assert_array_equal(teng._spec_cols.numpy(), np.asarray(jeng._spec_cols))
    return ref, ours, teng


def _submit_all(texts, **kw):
    def run(eng):
        reqs = [eng.submit(t, **kw) for t in texts]
        eng.run_until_idle()
        return reqs
    return run


class TestSpecGreedyParity:
    @pytest.mark.parametrize("mode", MODES)
    def test_single_request(self, models, mode):
        ref, ours, _ = both(models, "other", _submit_all(TEXTS[:1], min_frames=8, max_frames=64),
                            n_slots=2, max_prompt=64, max_frames=64, top_k=1, gamma=3,
                            residual_mode=mode)
        assert_same_requests(ref, ours)
        if mode == "strict":  # exact target greedy: the one-shot codes
            one = models["target"][1].generate_codes([TEXTS[0]], min_frames=8, max_frames=64,
                                                     temperature=1.0, top_k=1)[0]
            n = min(len(one), ours[0].n_frames)
            np.testing.assert_array_equal(ours[0].codes[:n], one[:n])

    @pytest.mark.parametrize("mode", MODES)
    def test_concurrent_queued_and_recycled_slots(self, models, mode):
        ref, ours, _ = both(models, "other", _submit_all(TEXTS, min_frames=8, max_frames=64),
                            n_slots=2, max_prompt=64, max_frames=64, top_k=1, gamma=3,
                            residual_mode=mode)
        assert_same_requests(ref, ours)

    def test_identical_draft_high_acceptance_parity(self, models):
        ref, ours, eng = both(models, "same",
                              _submit_all(TEXTS[:2], min_frames=16, max_frames=64),
                              n_slots=2, max_prompt=64, max_frames=64, top_k=1, gamma=3,
                              residual_mode="strict")
        assert_same_requests(ref, ours, waves=False)
        assert sum(r.n_frames for r in ours) / eng.spec_rounds > 1.5

    def test_recycled_columns_reset_per_row(self, models):
        """One slot, requests back to back: each admission resets the row's
        columns over the previous occupant's stale K/V."""
        ref, ours, _ = both(models, "same", _submit_all(TEXTS[:3], min_frames=16, max_frames=64),
                            n_slots=1, max_prompt=64, max_frames=64, top_k=1, gamma=2,
                            residual_mode="strict")
        assert_same_requests(ref, ours, waves=False)


class TestSpecColumnRewind:
    def test_rewound_columns_stay_bounded(self, models):
        ref, ours, eng = both(models, "other",
                              _submit_all(TEXTS[:1], min_frames=48, max_frames=64),
                              n_slots=1, max_prompt=64, max_frames=64, top_k=1, gamma=3,
                              residual_mode="strict")
        assert_same_requests(ref, ours, waves=False)
        cols = int(eng._spec_cols[0])
        assert cols <= eng.ring and cols <= 64 + ours[0].n_frames + 3 * (eng.gamma + 1)


class TestSpecSampled:
    def test_sampled_schedule_independent(self, models):
        kw = dict(top_k=4, gamma=3, residual_mode="draft", max_prompt=64, max_frames=64)
        outs = []
        for i, Engine in enumerate((JEngine, TEngine)):
            target, draft = models["target"][i], models["other"][i]
            solo_eng = Engine(target, n_slots=1, draft_model=draft, **kw)
            solo = solo_eng.submit(TEXTS[0], min_frames=8, max_frames=64, seed=3)
            solo_eng.run_until_idle()
            eng = Engine(target, n_slots=2, draft_model=draft, **kw)
            filler = eng.submit(TEXTS[2], min_frames=24, max_frames=64, seed=9)
            eng.step()
            shared = eng.submit(TEXTS[0], min_frames=8, max_frames=64, seed=3)
            eng.run_until_idle()
            np.testing.assert_array_equal(shared.codes, solo.codes)
            outs.append([solo, filler, shared])
        assert_same_requests(*outs, waves=False)

    @pytest.mark.parametrize("mode", MODES)
    def test_sampled_identical_draft_high_acceptance(self, models, mode):
        """With p == q the rejection sampler accepts nearly everything at
        top_k > 1 too."""
        def seeded(eng):
            reqs = [eng.submit(t, min_frames=96, max_frames=128, seed=i, temperature=0.9)
                    for i, t in enumerate(TEXTS[:4])]
            eng.run_until_idle()
            return reqs

        ref, ours, eng = both(models, "same", seeded, n_slots=2, max_prompt=64,
                              max_frames=128, top_k=4, gamma=4, residual_mode=mode)
        assert_same_requests(ref, ours, waves=False)
        assert sum(r.n_frames for r in ours) / max(eng.spec_rounds, 1) > 5.0

    def test_draft_mode_valid_codes(self, models):
        ref, ours, _ = both(models, "other", _submit_all(TEXTS[1:2], min_frames=16,
                                                         max_frames=64),
                            n_slots=2, max_prompt=64, max_frames=64, top_k=4, gamma=4,
                            residual_mode="draft")
        assert_same_requests(ref, ours)
        codes = ours[0].codes
        cb = models["target"][1].config.codec.codebook_size
        assert codes.shape[0] >= 16 and (codes[:, 0] < cb).all() and (codes >= 0).all()


class TestSpecStreaming:
    def test_stream_pieces_concat_to_result(self, models):
        def run(eng):
            req = eng.submit(TEXTS[0], min_frames=64, max_frames=64, stream=True)
            eng.run_until_idle()
            pieces = [p for p, _sr in req.chunks(timeout=60)]
            assert len(pieces) >= 2
            wav, _sr = req.result(timeout=5)
            cat = (torch.cat(pieces) if isinstance(wav, torch.Tensor)
                   else np.concatenate(pieces))
            np.testing.assert_array_equal(np.asarray(cat), np.asarray(wav))
            return [req]

        ref, ours, _ = both(models, "same", run, n_slots=2, max_prompt=64, max_frames=64,
                            top_k=1, gamma=3, residual_mode="strict")
        assert_same_requests(ref, ours)


class TestSpecValidation:
    def test_vocab_mismatch_and_bad_residual_mode_rejected(self, models):
        import dataclasses

        from rho_tts_tpu_torch.models.qwen import PRESETS
        from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel

        target = models["target"][1]
        cfg = dataclasses.replace(
            PRESETS["tiny"], codec=dataclasses.replace(PRESETS["tiny"].codec, codebook_size=32))
        with pytest.raises(ValueError, match="vocabular"):
            TEngine(target, n_slots=1, draft_model=QwenTTSModel(cfg, device="cpu"))
        with pytest.raises(ValueError, match="residual_mode"):
            TEngine(target, n_slots=1, draft_model=models["other"][1], residual_mode="nope")

    def test_eos_at_admission_retires(self, models):
        ref, ours, _ = both(models, "other", _submit_all(TEXTS[:2], min_frames=0, max_frames=64),
                            n_slots=1, max_prompt=64, max_frames=64, top_k=1, gamma=2,
                            residual_mode="strict")
        assert_same_requests(ref, ours, waves=False)
        assert all(r.n_frames >= 1 for r in ours)


def test_results_invariant_to_spec_rounds(models, monkeypatch):
    """k rounds per dispatch emit the same codes as one round per dispatch,
    in both packages."""
    outs = {}
    for k in ("1", "3"):
        monkeypatch.setenv("RHO_TTS_TPU_SPEC_ROUNDS", k)

        def seeded(eng):
            reqs = [eng.submit(t, min_frames=8, max_frames=64, seed=i, temperature=0.9)
                    for i, t in enumerate(TEXTS[:2])]
            eng.run_until_idle()
            return reqs

        ref, ours, _ = both(models, "other", seeded, n_slots=2, max_prompt=64, max_frames=64,
                            top_k=4, gamma=4, residual_mode="draft")
        assert_same_requests(ref, ours, waves=False)
        outs[k] = [r.codes for r in ours]
    for a, b in zip(outs["1"], outs["3"]):
        np.testing.assert_array_equal(a, b)
