"""Port parity of the isolation layer with real worker processes on the CPU.

JAX's tiny fp32 weights (``fp32_params`` of ``test_torch_port_slice.py``)
become a native CustomVoice checkpoint through the port's
``save_checkpoint``; a "venv" is made by hand under ``tmp_path`` (an
interpreter script that runs this interpreter, and a current marker), so
``ProviderProxy`` spawns ``python -m rho_tts_tpu_torch.isolation.worker``
with no pip and no network. One module-scoped worker serves the generate,
stream, cancel and ping checks; one more is killed.

The worker's WAVs are byte-equal to the port's in-process ``generate``
(written by the same ``save_wav``), and within 1e-4 + 1 int16 LSB of the
JAX provider's in-process waveforms on the same weights (its prefill
through the Pallas kernel in interpret mode, as in
``test_torch_port_provider.py``).

Every blocking call on a worker runs under :func:`_within`, which kills
the worker and fails after ``CALL_TIMEOUT_S``: a hung worker fails here
and does not stall the suite.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rho_tts_tpu.models.qwen import PRESETS as JPRESETS
from rho_tts_tpu.models.qwen.model import QwenTTSModel as JModel
from rho_tts_tpu.providers.qwen import QwenTTS as JQwenTTS
from rho_tts_tpu_torch import CancellationToken, audio_io, from_jax
from rho_tts_tpu_torch.isolation import ProviderProxy, venvs
from rho_tts_tpu_torch.models.qwen import PRESETS as TPRESETS
from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel as TModel
from rho_tts_tpu_torch.providers.qwen import QwenTTS as TQwenTTS
from test_torch_port_slice import fp32_params, jax_prefill_kernel  # noqa: F401 — fixtures

torch.set_num_threads(1)  # several test workers share the cores

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
TEXTS = ["isolated worker parity", "a second, slightly longer line of text here"]
KW = dict(device="cpu", seed=1234, max_chars_per_segment=200, max_iterations=1,
          min_audio_sec=1.0, speaker="Aria")
CALL_TIMEOUT_S = 60
LSB = 1.0 / 32768


def _within(fn, proxy=None, timeout=CALL_TIMEOUT_S):
    """``fn()`` on a thread; past ``timeout`` the worker is killed and the test fails."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    if th.is_alive():
        worker = getattr(proxy, "_worker", None)
        if worker is not None and worker._pipe is not None:
            worker._pipe.proc.kill()
        pytest.fail(f"a worker call ran past {timeout} s")
    if "err" in box:
        raise box["err"]
    return box.get("out")


def _fake_venv(root):
    """The qwen venv the proxy looks for: this interpreter, a current marker."""
    py = os.path.join(root, "qwen", "bin", "python")
    os.makedirs(os.path.dirname(py))
    with open(py, "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(py, 0o755)
    with open(os.path.join(root, "qwen", venvs.MARKER_FILE), "w") as f:
        f.write(venvs.source_hash())


@pytest.fixture(scope="module")
def env(fp32_params, tmp_path_factory):  # noqa: F811
    import jax

    root = tmp_path_factory.mktemp("isolation")
    jm = JModel(JPRESETS["tiny"], params=fp32_params)
    tp = from_jax.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu")
    tm = TModel(TPRESETS["tiny"], params=tp, device="cpu")
    tm.variant = "custom-voice"
    ckpt = str(root / "ckpt")
    tm.save_checkpoint(ckpt)
    _fake_venv(str(root / "venvs"))
    mp = pytest.MonkeyPatch()
    mp.setattr(venvs, "VENVS_ROOT", root / "venvs")
    mp.setenv("PYTHONPATH", os.pathsep.join(p for p in (SRC, os.environ.get("PYTHONPATH"))
                                            if p))
    # one intra-op thread in the worker too: the CPU's sums then run in this
    # process's order, so the two processes' samples can be byte-equal
    mp.setenv("OMP_NUM_THREADS", "1")
    yield {"root": root, "ckpt": ckpt, "jm": jm}
    mp.undo()


@pytest.fixture(scope="module")
def proxy(env):
    p = _within(lambda: ProviderProxy("qwen", model_path=env["ckpt"], **KW))
    yield p
    _within(p.close, p)


def test_worker_handshake(proxy):
    assert proxy.sample_rate == TPRESETS["tiny"].codec.sample_rate
    assert _within(proxy.ping, proxy) is True
    assert proxy._worker.alive


def test_worker_wavs_match_in_process_and_jax(env, proxy, jax_prefill_kernel, tmp_path):  # noqa: F811
    got = _within(lambda: proxy.generate(TEXTS, str(tmp_path / "proxied")), proxy)
    local = TQwenTTS(model_path=env["ckpt"], **KW).generate(TEXTS, str(tmp_path / "local"))
    ref_tts = JQwenTTS(model_path="tiny-CustomVoice", **KW)
    ref_tts._model = env["jm"]
    ref = ref_tts.generate(TEXTS)
    assert len(got) == len(local) == len(ref) == len(TEXTS)
    for g, loc, r in zip(got, local, ref):
        with open(g.path, "rb") as f, open(loc.path, "rb") as h:
            assert f.read() == h.read()  # the same bytes as the in-process port
        assert (g.segments_count, g.duration_sec) == (loc.segments_count, loc.duration_sec)
        wav, sr = audio_io.load_wav(g.path)
        assert sr == proxy.sample_rate
        r_audio = np.asarray(r.audio)
        assert wav.shape == r_audio.shape and g.segments_count == r.segments_count
        np.testing.assert_allclose(wav, r_audio, atol=1e-4 + LSB, rtol=0)


def test_in_memory_generate_and_stream(env, proxy):
    one = _within(lambda: proxy.generate(TEXTS[0]), proxy)
    local_tts = TQwenTTS(model_path=env["ckpt"], **KW)
    local = local_tts.generate(TEXTS[0])
    assert isinstance(one.audio, torch.Tensor) and one.audio.device.type == "cpu"
    assert one.path is None and one.audio.dtype == torch.float32
    want = audio_io._to_int16(local.numpy()).astype(np.float32) / 32768.0
    np.testing.assert_array_equal(one.numpy(), want)

    pieces = _within(lambda: list(proxy.stream(TEXTS[1])), proxy)
    local_pieces = list(local_tts.stream(TEXTS[1], chunked=False))
    assert len(pieces) == len(local_pieces) >= 1
    for p, q in zip(pieces, local_pieces):
        assert p.duration_sec == q.duration_sec
        np.testing.assert_array_equal(np.round(p.numpy() * 32768).astype(np.int16),
                                      audio_io._to_int16(q.numpy()))


def test_cancel_then_ping_then_generate(proxy, tmp_path):
    # The worker drops a CANCEL that it reads before the GENERATE has started
    # (as the JAX worker does), so besides the proxy's forwarder the test
    # repeats CANCEL every 10 ms until the call returns: one lands in it.
    token = CancellationToken()
    token.cancel()  # the forwarder sends CANCEL at its first poll
    done = threading.Event()

    def repeat_cancel():
        while not done.wait(0.01):
            proxy._worker.send_cancel()

    threading.Thread(target=repeat_cancel, daemon=True).start()
    try:
        out = _within(lambda: proxy.generate(TEXTS * 8, str(tmp_path / "c"),
                                             cancellation_token=token), proxy)
    finally:
        done.set()
    assert out is None
    assert _within(proxy.ping, proxy) is True
    after = _within(lambda: proxy.generate(TEXTS, str(tmp_path / "after")), proxy)
    assert [os.path.isfile(r.path) for r in after] == [True, True]


def test_killed_worker_is_restarted_without_init(env, tmp_path):
    """The worker dies with a request in flight: the proxy restarts it and
    raises; the new worker is sent no INIT, answers the next request with an
    ERROR and exits; after that the proxy refuses before writing."""
    p = _within(lambda: ProviderProxy("qwen", model_path=env["ckpt"], **KW))
    try:
        pipe = p._worker._pipe

        def write_then_kill(msg_type, **payload):
            type(pipe).write(pipe, msg_type, **payload)
            pipe.proc.kill()
            pipe.proc.wait(timeout=CALL_TIMEOUT_S)

        pipe.write = write_then_kill
        outcomes = []
        for i in range(3):
            try:
                _within(lambda: p.generate(TEXTS[0], str(tmp_path / "x.wav")), p)
                outcomes.append(None)
            except RuntimeError as e:
                outcomes.append(str(e))
            if i == 1:
                p._worker._pipe.proc.wait(timeout=CALL_TIMEOUT_S)
        assert outcomes[0].startswith("Worker crashed and was restarted")
        assert outcomes[1] == "Worker error: Expected 'init' as first message"
        assert outcomes[2] == "Worker is not running"
        assert p._worker._restart_count == 1
    finally:
        _within(p.close, p)
    assert p._worker is None
