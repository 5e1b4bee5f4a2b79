"""Port parity of the isolation layer, with no subprocess.

The same inputs go through ``rho_tts_tpu.isolation`` and
``rho_tts_tpu_torch.isolation``:

* protocol: ``encode_message`` gives the same bytes for every frame, and
  the same ``MessageError`` for every malformed line;
* worker: the same scripted stdin lines through both packages' real
  ``Worker().run()`` (over fake stdio, each with a fake TTS) give equal
  response lists, and equal WAV bytes for streamed segments;
* procman, proxy, venvs: the mocked-``Popen`` / scripted-worker checks of
  ``tests/test_isolation/``, run on both packages with equal outcomes;
* factory: the isolation route, ``list_providers`` and the static provider
  info, field by field equal to the JAX package's;
* the restart-without-``INIT`` sequence of a crashed worker (the restarted
  worker is never sent ``INIT``), equal in both packages over fake pipes.
"""

import io
import json
import os
import threading
import time
from pathlib import Path
from unittest.mock import MagicMock, patch

import numpy as np
import pytest
import torch

import rho_tts_tpu.isolation.procman as jprocman
import rho_tts_tpu.isolation.protocol as JP
import rho_tts_tpu.isolation.proxy as jproxy
import rho_tts_tpu.isolation.venvs as jvenvs
import rho_tts_tpu.isolation.worker as jworker
import rho_tts_tpu_torch.isolation.procman as tprocman
import rho_tts_tpu_torch.isolation.protocol as TP
import rho_tts_tpu_torch.isolation.proxy as tproxy
import rho_tts_tpu_torch.isolation.venvs as tvenvs
import rho_tts_tpu_torch.isolation.worker as tworker
from rho_tts_tpu import factory as jfactory
from rho_tts_tpu.result import GenerationResult as JResult
from rho_tts_tpu_torch import factory as tfactory
from rho_tts_tpu_torch.cancellation import CancellationToken
from rho_tts_tpu_torch.exceptions import ModelLoadError
from rho_tts_tpu_torch.result import GenerationResult as TResult

PACKAGES = {
    "jax": dict(P=JP, worker=jworker, procman=jprocman, proxy=jproxy, venvs=jvenvs,
                Result=JResult, mod="rho_tts_tpu"),
    "torch": dict(P=TP, worker=tworker, procman=tprocman, proxy=tproxy, venvs=tvenvs,
                  Result=TResult, mod="rho_tts_tpu_torch"),
}
SR = 24000
WAIT_S = 30  # every blocking wait here fails after this, never hangs


# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------

FRAMES = [
    ("init", {"provider": "qwen", "kwargs": {"seed": 7, "device": "cuda", "speaker": "Vivian",
                                            "min_audio_sec": 1000.0, "quantization": None}}),
    ("generate", {"text": "héllo — wörld", "output_path": "/tmp/o.wav", "format": "wav",
                  "speed": 1.5, "pitch_semitones": -2.0}),
    ("generate", {"texts": ["a", "b"], "output_base_path": "/tmp/b", "format": "mp3",
                  "speed": 1.0, "pitch_semitones": 0.0}),
    ("stream", {"text": "x", "temp_dir": "/tmp/s", "speed": 1.0, "pitch_semitones": 0.0}),
    ("cancel", {}),
    ("shutdown", {}),
    ("ping", {}),
    ("ready", {"sample_rate": 24000}),
    ("result", {"output_paths": ["/tmp/b_0.wav", None], "durations": [1.25, 0.0],
                "seg_counts": [2, 0], "format": "wav"}),
    ("result", {"output_path": "/tmp/o.wav", "success": True, "duration_sec": 3.0,
                "segments_count": 1, "format": "wav"}),
    ("result", {"success": False}),
    ("segment_result", {"path": "/tmp/seg_0.wav", "duration_sec": 0.5}),
    ("error", {"message": "Expected 'init' as first message"}),
    ("cancelled", {}),
    ("pong", {}),
    ("frobnicate", {"nested": {"a": [1, 2.5, None, True], "b": "\n"}}),
]


@pytest.mark.parametrize("msg_type,payload", FRAMES, ids=[f[0] + str(i) for i, f in
                                                          enumerate(FRAMES)])
def test_encode_message_bytes_equal_jax(msg_type, payload):
    ours = TP.encode_message(msg_type, **payload)
    assert ours == JP.encode_message(msg_type, **payload)
    assert ours.endswith("\n") and ours.count("\n") == 1
    assert TP.decode_message(ours) == JP.decode_message(ours) == {"type": msg_type, **payload}


@pytest.mark.parametrize("line", ["not json\n", "[1, 2]\n", '{"no_type": 1}\n', "", "42\n",
                                  '{"type": "ping"\n'])
def test_decode_errors_match_jax(line):
    with pytest.raises(JP.MessageError) as jerr:
        JP.decode_message(line)
    with pytest.raises(TP.MessageError) as terr:
        TP.decode_message(line)
    assert str(terr.value) == str(jerr.value)
    assert issubclass(TP.MessageError, ValueError)


def test_protocol_constants_match_jax():
    names = ["PROTOCOL_VERSION", "INIT", "GENERATE", "STREAM", "CANCEL", "SHUTDOWN", "PING",
             "READY", "RESULT", "SEGMENT_RESULT", "ERROR", "CANCELLED", "PONG",
             "REQUEST_TYPES", "RESPONSE_TYPES"]
    assert {n: getattr(TP, n) for n in names} == {n: getattr(JP, n) for n in names}
    assert TP.PROTOCOL_VERSION == 1


# ---------------------------------------------------------------------------
# Worker: the real message loop over fake stdio, in both packages
# ---------------------------------------------------------------------------


class _GatedStdin:
    """stdin whose line ``gate_at`` is held back until ``gate`` is set."""

    def __init__(self, lines, gate=None, gate_at=None):
        self._lines, self._gate, self._gate_at, self._i = list(lines), gate, gate_at, 0
        self._lock = threading.Lock()

    def readline(self):
        with self._lock:
            i = self._i
            self._i += 1
        if i >= len(self._lines):
            return ""
        if self._gate is not None and i == self._gate_at:
            assert self._gate.wait(WAIT_S), "the gated line was never released"
        return self._lines[i]


def _audio(n=480, hz=330.0):
    t = np.arange(n) / SR
    return (0.4 * np.sin(2 * np.pi * hz * t)).astype(np.float32)


def _fake_tts(pkg, scenario, gate):
    """A TTS stand-in for ``scenario``, built of ``pkg``'s own result type."""
    R = PACKAGES[pkg]["Result"]

    def wav(a):
        return a if pkg == "jax" else torch.from_numpy(a)

    tts = MagicMock()
    tts.sample_rate = SR
    if scenario == "generate_single":
        tts.generate.return_value = R(path="/tmp/out.wav", audio=wav(_audio()), sample_rate=SR,
                                      duration_sec=1.5, segments_count=2, format="wav")
    elif scenario == "generate_batch":
        tts.generate.return_value = [
            R(path="/tmp/b_0.wav", audio=wav(_audio()), duration_sec=1.0, segments_count=1),
            None,
            R(path="/tmp/b_2.wav", audio=wav(_audio(240)), duration_sec=0.5, segments_count=3),
        ]
    elif scenario == "generate_none":
        tts.generate.return_value = None
    elif scenario == "generate_raises":
        tts.generate.side_effect = RuntimeError("device exploded")
    elif scenario == "generate_in_memory":
        tts.generate.return_value = R(path=None, audio=None, sample_rate=SR, duration_sec=0.0,
                                      segments_count=0, format="wav")
    elif scenario == "stream":
        tts.stream.return_value = iter([
            R(audio=wav(_audio(480, 220.0)), sample_rate=SR, duration_sec=0.02, segments_count=1),
            R(audio=wav(_audio(960, 440.0)), sample_rate=SR, duration_sec=0.04, segments_count=1),
        ])
    elif scenario == "cancel":
        def blocking(texts, out, cancellation_token=None, **kw):
            gate.set()  # the CANCEL line may be read now
            deadline = time.monotonic() + WAIT_S
            while not cancellation_token.is_cancelled() and time.monotonic() < deadline:
                time.sleep(0.005)
            return None

        tts.generate.side_effect = blocking
    return tts


def _script(P, scenario, tmp):
    init = P.encode_message(P.INIT, provider="qwen", kwargs={"seed": 7, "device": "cpu"})
    shut = P.encode_message(P.SHUTDOWN)
    body = {
        "init_only": [],
        "generate_single": [P.encode_message(P.GENERATE, text="hello",
                                             output_path="/tmp/out.wav")],
        "generate_batch": [P.encode_message(P.GENERATE, texts=["a", "b", "c"],
                                            output_base_path="/tmp/b", format="wav")],
        "generate_none": [P.encode_message(P.GENERATE, text="x")],
        "generate_raises": [P.encode_message(P.GENERATE, text="x")],
        "generate_in_memory": [P.encode_message(P.GENERATE, text="x", speed=2.0)],
        "stream": [P.encode_message(P.STREAM, text="x", temp_dir=str(tmp))],
        "cancel": [P.encode_message(P.GENERATE, texts=["a"], output_base_path="/tmp/c"),
                   P.encode_message(P.CANCEL)],
        "ping": [P.encode_message(P.PING)],
        "unknown": [P.encode_message("frobnicate")],
    }
    if scenario == "init_failure":
        return [init, shut]
    if scenario == "not_init_first":
        return [P.encode_message(P.GENERATE, text="x"), shut]
    if scenario == "eof":
        return [init]
    return [init, *body[scenario], shut]


def _run_worker(pkg, scenario, tmp):
    parts = PACKAGES[pkg]
    gate = threading.Event()
    lines = _script(parts["P"], scenario, tmp)
    stdin = _GatedStdin(lines, gate, len(lines) - 2) if scenario == "cancel" else \
        _GatedStdin(lines)
    stdout = io.StringIO()
    with patch(f"{parts['mod']}.isolation.worker.TTSFactory") as factory, \
            patch("sys.stdin", stdin), patch("sys.stdout", stdout):
        if scenario == "init_failure":
            factory.get_tts_instance.side_effect = RuntimeError("no device")
        else:
            factory.get_tts_instance.return_value = _fake_tts(pkg, scenario, gate)
        th = threading.Thread(target=parts["worker"].Worker().run, daemon=True)
        th.start()
        th.join(WAIT_S)
        assert not th.is_alive(), f"{pkg} worker loop did not end"
    tts_calls = factory.get_tts_instance.call_args_list
    return [json.loads(line) for line in stdout.getvalue().splitlines()], tts_calls


SCENARIOS = ["init_only", "init_failure", "not_init_first", "eof", "generate_single",
             "generate_batch", "generate_none", "generate_raises", "generate_in_memory",
             "stream", "cancel", "ping", "unknown"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_worker_responses_equal_jax(scenario, tmp_path):
    wavs = {}
    out = {}
    for pkg in ("jax", "torch"):
        tmp = tmp_path / "seg"
        tmp.mkdir(exist_ok=True)
        out[pkg] = _run_worker(pkg, scenario, tmp)
        wavs[pkg] = {p.name: p.read_bytes() for p in sorted(tmp.iterdir())}
        for p in tmp.iterdir():
            p.unlink()
    (ours, our_calls), (ref, ref_calls) = out["torch"], out["jax"]
    assert ours == ref
    assert our_calls == ref_calls
    assert wavs["torch"] == wavs["jax"]
    expected_first = {"init_failure": "error", "not_init_first": "error"}.get(scenario, "ready")
    if scenario != "eof":
        assert ours and ours[0]["type"] == expected_first
    if scenario == "stream":
        assert [r["type"] for r in ours] == ["ready", "segment_result", "segment_result", "result"]
        assert len(wavs["torch"]) == 2
    if scenario == "cancel":
        assert [r["type"] for r in ours] == ["ready", "cancelled"]
    if scenario == "ping":
        assert [r["type"] for r in ours] == ["ready", "pong"]


def test_worker_stream_uses_the_ports_wav_writer(tmp_path):
    """A streamed segment's WAV holds the result's samples as the port saves them."""
    from rho_tts_tpu_torch.audio_io import _to_int16, load_wav

    responses, _ = _run_worker("torch", "stream", tmp_path)
    seg = responses[1]
    wav, sr = load_wav(seg["path"])
    assert sr == SR and seg["duration_sec"] == 0.02
    np.testing.assert_array_equal(np.round(wav * 32768).astype(np.int16),
                                  _to_int16(_audio(480, 220.0)))


def test_worker_module_entry_point():
    src = (Path(tworker.__file__).parent / "__main__.py").read_text()
    assert "rho_tts_tpu_torch.isolation.worker import main" in src
    assert tprocman.WORKER_MODULE == "rho_tts_tpu_torch.isolation.worker"


# ---------------------------------------------------------------------------
# procman with a mocked Popen
# ---------------------------------------------------------------------------


def _proc(responses=None):
    proc = MagicMock()
    proc.poll.return_value = None
    proc.stderr.readline.return_value = ""  # the stderr relay ends at once
    if responses is not None:
        proc.stdout.readline.side_effect = responses
    return proc


def _procman_outcomes(pkg):
    """The ``tests/test_isolation/test_procman.py`` scenarios, as data."""
    parts = PACKAGES[pkg]
    P, WorkerProcess = parts["P"], parts["procman"].WorkerProcess
    out = {}
    with patch("subprocess.Popen") as popen:
        popen.return_value = _proc()
        wp = WorkerProcess("/venv/bin/python")
        wp.start()
    out["cmd"] = popen.call_args[0][0]
    out["popen_kwargs"] = {k: v for k, v in popen.call_args[1].items()}

    proc = _proc([json.dumps({"type": P.READY, "sample_rate": SR}) + "\n"])
    with patch("subprocess.Popen", return_value=proc):
        wp = WorkerProcess("/p")
        wp.start()
        out["roundtrip"] = wp.send(P.INIT, provider="qwen", kwargs={})
    out["roundtrip_written"] = proc.stdin.write.call_args[0][0]

    proc = _proc()
    proc.stdout.readline.return_value = ""
    errors = []
    with patch("subprocess.Popen", return_value=proc) as popen:
        wp = WorkerProcess("/p")
        wp.start()
        for _ in range(parts["procman"].MAX_RESTARTS + 1):
            try:
                wp.send(P.PING)
            except RuntimeError as e:
                errors.append(str(e))
    out["restart_errors"], out["spawns"] = errors, popen.call_count

    proc = _proc([json.dumps({"type": P.PONG}) + "\n"])
    with patch("subprocess.Popen", return_value=proc):
        wp = WorkerProcess("/p")
        wp.start()
        out["ping"] = wp.ping()
    out["ping_dead"] = WorkerProcess("/p").ping()

    proc = _proc()
    with patch("subprocess.Popen", return_value=proc):
        wp = WorkerProcess("/p")
        wp.start()
        wp.send_cancel()
        out["cancel_written"] = proc.stdin.write.call_args[0][0]
        wp.shutdown()
        out["shutdown_written"] = proc.stdin.write.call_args[0][0]
        out["shutdown_wait"] = proc.wait.call_args
        wp.kill()
        out["alive_after_kill"] = wp.alive
    try:
        WorkerProcess("/p").send(P.PING)
    except RuntimeError as e:
        out["not_running"] = str(e)
    return out


def test_procman_behaves_as_jax():
    ours, ref = _procman_outcomes("torch"), _procman_outcomes("jax")
    assert ours.pop("cmd") == ["/venv/bin/python", "-m", "rho_tts_tpu_torch.isolation.worker"]
    assert ref.pop("cmd") == ["/venv/bin/python", "-m", "rho_tts_tpu.isolation.worker"]
    assert ours == ref
    assert ours["restart_errors"][-1].endswith("giving up")
    for name in ("MAX_RESTARTS", "SHUTDOWN_GRACE_SEC", "KILL_WAIT_SEC"):
        assert getattr(tprocman, name) == getattr(jprocman, name)


# ---------------------------------------------------------------------------
# ProviderProxy with a scripted worker
# ---------------------------------------------------------------------------


def _make_proxy(pkg, responses, **kwargs):
    parts = PACKAGES[pkg]
    worker = MagicMock()
    worker.send.side_effect = responses
    with patch(f"{parts['mod']}.isolation.proxy.VenvManager") as vm, \
            patch(f"{parts['mod']}.isolation.proxy.WorkerProcess", return_value=worker):
        vm.return_value.ensure_venv.return_value = "/fake/python"
        proxy = parts["proxy"].ProviderProxy("qwen", **kwargs)
    return proxy, worker


READY = {"type": "ready", "sample_rate": SR}


def test_proxy_handshake_equal_jax():
    for pkg in ("jax", "torch"):
        proxy, worker = _make_proxy(pkg, [READY], seed=3, device="cuda")
        assert proxy.sample_rate == SR
        worker.send.assert_called_once_with("init", provider="qwen",
                                            kwargs={"seed": 3, "device": "cuda"})


def test_proxy_init_error_raises_model_load_error():
    worker = MagicMock()
    worker.send.return_value = {"type": "error", "message": "boom"}
    with patch("rho_tts_tpu_torch.isolation.proxy.VenvManager") as vm, \
            patch("rho_tts_tpu_torch.isolation.proxy.WorkerProcess", return_value=worker):
        vm.return_value.ensure_venv.return_value = "/fake/python"
        with pytest.raises(ModelLoadError, match="boom"):
            tproxy.ProviderProxy("qwen")
        worker.send.return_value = {"type": "pong"}
        with pytest.raises(ModelLoadError, match="Unexpected response"):
            tproxy.ProviderProxy("qwen")
    assert worker.kill.call_count == 2


@pytest.mark.parametrize("batch", [False, True])
def test_proxy_in_memory_results_are_cpu_tensors(tmp_path, batch):
    """In-memory generate: the worker's WAVs come back as CPU float32 tensors
    equal to JAX's arrays, and the proxy's temp dir is removed."""
    from rho_tts_tpu.audio_io import save_wav

    made, out = [], {}
    for pkg in ("jax", "torch"):
        proxy, worker = _make_proxy(pkg, [READY])

        def fake_generate(msg_type, **payload):
            base = payload.get("output_path") or payload["output_base_path"]
            made.append(os.path.dirname(base))
            if not batch:
                save_wav(base, _audio(100) * 0.5, SR)
                return {"type": "result", "success": True, "output_path": base,
                        "duration_sec": 100 / SR, "segments_count": 1, "format": "wav"}
            paths = [f"{base}_0.wav", None, f"{base}_2.wav"]
            save_wav(paths[0], _audio(100), SR)
            save_wav(paths[2], _audio(50, 120.0), SR)
            return {"type": "result", "output_paths": paths, "durations": [0.1, 0.0, 0.05],
                    "seg_counts": [1, 0, 2], "format": "wav"}

        worker.send.side_effect = fake_generate
        out[pkg] = proxy.generate(["a", "b", "c"] if batch else "hello")
    ours, ref = out["torch"], out["jax"]
    ours, ref = (ours, ref) if batch else ([ours], [ref])
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        if r is None:
            assert o is None
            continue
        assert isinstance(o.audio, torch.Tensor) and o.audio.device.type == "cpu"
        assert o.audio.dtype == torch.float32 and o.path is None
        np.testing.assert_array_equal(o.numpy(), np.asarray(r.audio))
        assert (o.duration_sec, o.segments_count, o.sample_rate, o.format) == \
            (r.duration_sec, r.segments_count, r.sample_rate, r.format)
    assert made and not any(os.path.exists(d) for d in made)  # temp dirs removed


def test_proxy_results_with_paths_and_errors_equal_jax():
    script = [READY,
              {"type": "result", "success": True, "output_path": "/tmp/o.wav",
               "duration_sec": 2.0, "segments_count": 3, "format": "wav"},
              {"type": "result", "output_paths": ["/tmp/a_0.wav", None],
               "durations": [1.0, 0.0], "seg_counts": [1, 0], "format": "wav"},
              {"type": "result", "output_paths": [None], "format": "wav"},
              {"type": "result", "success": False},
              {"type": "cancelled"},
              {"type": "error", "message": "oops"},
              {"type": "weird"}]
    seen = {}
    for pkg in ("jax", "torch"):
        proxy, _ = _make_proxy(pkg, list(script))
        got = []
        for texts, path in (("x", "/tmp/o.wav"), (["a", "b"], "/tmp/a"), (["a"], "/tmp/a"),
                            ("x", "/tmp/x.wav"), ("x", "/tmp/x.wav"), ("x", "/tmp/x.wav"),
                            ("x", "/tmp/x.wav")):
            try:
                r = proxy.generate(texts, path)
                got.append(r if r is None or isinstance(r, list) else [r])
            except RuntimeError as e:
                got.append(str(e))
        seen[pkg] = [g if not isinstance(g, list) else
                     [None if r is None else (r.path, r.duration_sec, r.segments_count, r.format)
                      for r in g] for g in got]
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][-2] == "Worker error: oops"


def test_proxy_cancel_forwarder_sends_cancel():
    proxy, worker = _make_proxy("torch", [READY])
    token = CancellationToken()
    token.cancel()

    def slow_generate(msg_type, **payload):
        deadline = time.monotonic() + WAIT_S
        while not worker.send_cancel.called and time.monotonic() < deadline:
            time.sleep(0.01)  # the forwarder polls every 0.1 s
        return {"type": "cancelled"}

    worker.send.side_effect = slow_generate
    assert proxy.generate("x", "/tmp/x.wav", cancellation_token=token) is None
    worker.send_cancel.assert_called()


def test_proxy_stream_yields_cpu_tensors(tmp_path):
    from rho_tts_tpu_torch.audio_io import save_wav

    seg_path = str(tmp_path / "seg_0.wav")
    save_wav(seg_path, _audio(50), SR)
    proxy, worker = _make_proxy("torch", [READY])
    worker.receive.side_effect = [
        {"type": "segment_result", "path": seg_path, "duration_sec": 50 / SR},
        {"type": "segment_result", "path": str(tmp_path / "missing.wav"), "duration_sec": 1.0},
        {"type": "result", "success": True, "segments": 2},
    ]
    results = list(proxy.stream("hello"))
    assert len(results) == 1 and isinstance(results[0].audio, torch.Tensor)
    assert results[0].audio.shape == (50,) and results[0].segments_count == 1
    assert not os.path.exists(seg_path)  # consumed segments are deleted
    kind, = worker.send_nowait.call_args[0]
    assert kind == "stream" and not os.path.exists(worker.send_nowait.call_args[1]["temp_dir"])


def test_proxy_lifecycle_and_async():
    import asyncio

    proxy, worker = _make_proxy("torch", [READY, {"type": "result", "success": True,
                                                  "output_path": "/tmp/a.wav",
                                                  "duration_sec": 1.0, "segments_count": 1,
                                                  "format": "wav"}])
    worker.ping.return_value = True
    assert proxy.ping() is True

    async def run():
        return await proxy.async_generate("hi", "/tmp/a.wav")

    assert asyncio.run(run()).path == "/tmp/a.wav"
    with proxy:
        pass
    proxy.shutdown()
    worker.shutdown.assert_called_once()
    assert proxy.ping() is False


# ---------------------------------------------------------------------------
# venvs
# ---------------------------------------------------------------------------


def test_venvs_constants():
    assert tvenvs.VENVS_ROOT == Path.home() / ".rho_tts_tpu_torch" / "venvs"
    assert tvenvs.VENVS_ROOT != jvenvs.VENVS_ROOT and tvenvs.MARKER_FILE != jvenvs.MARKER_FILE
    assert tvenvs.PROVIDER_EXTRAS == {"qwen": "torch", "chatterbox": "torch"}
    assert tvenvs.INSTALL_TIMEOUT_SEC == jvenvs.INSTALL_TIMEOUT_SEC
    # both hash the one pyproject.toml of the distribution
    assert tvenvs.source_hash() == jvenvs.source_hash() != "unknown"
    assert tvenvs.find_project_root() == jvenvs.find_project_root()


def _ok(code=0, stderr=""):
    r = MagicMock()
    r.returncode, r.stderr = code, stderr
    return r


def _fake_create(mgr):
    def create(path, with_pip, clear):
        Path(mgr.python).parent.mkdir(parents=True, exist_ok=True)
        Path(mgr.python).touch()
    return create


@pytest.mark.parametrize("provider", ["qwen", "chatterbox"])
def test_venv_created_installed_then_cached(tmp_path, provider):
    mgr = tvenvs.VenvManager(provider, venvs_root=tmp_path)
    with patch("venv.create", side_effect=_fake_create(mgr)) as create, \
            patch("subprocess.run", return_value=_ok()) as run:
        assert mgr.ensure_venv() == mgr.python == str(tmp_path / provider / "bin" / "python")
    create.assert_called_once()
    cmd = run.call_args[0][0]
    root = tvenvs.find_project_root()
    assert cmd == [mgr.python, "-m", "pip", "install", "-e", f"{root}[torch]"]
    assert (mgr.venv_dir / tvenvs.MARKER_FILE).read_text() == tvenvs.source_hash()
    with patch("venv.create") as create, patch("subprocess.run") as run:
        mgr.ensure_venv()
    create.assert_not_called()
    run.assert_not_called()


def test_venv_reinstalls_on_hash_change_and_reports_failure(tmp_path):
    mgr = tvenvs.VenvManager("qwen", venvs_root=tmp_path)
    Path(mgr.python).parent.mkdir(parents=True)
    Path(mgr.python).touch()
    mgr.marker.write_text("stale-hash")
    with patch("subprocess.run", return_value=_ok()) as run:
        mgr.ensure_venv()
    run.assert_called_once()
    mgr.marker.write_text("stale-again")
    with patch("subprocess.run", return_value=_ok(1, "pip exploded")):
        with pytest.raises(RuntimeError, match="Failed to install"):
            mgr.ensure_venv()
    with pytest.raises(ValueError, match="Unknown provider"):
        tvenvs.VenvManager("nonexistent", venvs_root=tmp_path)


def test_pip_install_from_an_installed_release():
    with patch.object(tvenvs, "find_project_root", return_value=None), \
            patch("subprocess.run", return_value=_ok()) as run:
        tvenvs.pip_install("/py", "torch")
    assert run.call_args[0][0] == ["/py", "-m", "pip", "install", "rho-tts-tpu[torch]"]


# ---------------------------------------------------------------------------
# The factory's route
# ---------------------------------------------------------------------------


@pytest.fixture
def factories():
    saved = [(f.TTSFactory._providers, set(f.TTSFactory._isolated_providers),
              f.TTSFactory._default_providers_registered) for f in (jfactory, tfactory)]
    yield jfactory.TTSFactory, tfactory.TTSFactory
    for f, (p, i, r) in zip((jfactory, tfactory), saved):
        f.TTSFactory._providers = p
        f.TTSFactory._isolated_providers = i
        f.TTSFactory._default_providers_registered = r


def _isolate(cls, names):
    cls._default_providers_registered = True
    cls._providers = {}
    cls._isolated_providers = set(names)


def test_static_provider_info_equals_jax():
    assert set(tfactory._STATIC_PROVIDER_INFO) == set(jfactory._STATIC_PROVIDER_INFO)
    for name, ref in jfactory._STATIC_PROVIDER_INFO.items():
        ours = tfactory._STATIC_PROVIDER_INFO[name]
        for field in ("name", "supports_voice_cloning", "supported_languages"):
            assert getattr(ours, field) == getattr(ref, field)
        assert [(v.id, v.name, v.language) for v in ours.builtin_voices] == \
            [(v.id, v.name, v.language) for v in ref.builtin_voices]
    assert [v.id for v in tfactory._builtin_voice_catalog()] == \
        [v.id for v in jfactory._builtin_voice_catalog()]


def test_factory_routes_isolated_providers_to_the_proxy(factories):
    jcls, tcls = factories
    for cls in factories:
        _isolate(cls, {"qwen", "mystery"})
    fake = MagicMock()
    with patch("rho_tts_tpu_torch.isolation.ProviderProxy", return_value=fake) as proxy_cls:
        assert tcls.get_tts_instance("qwen", seed=42, device="cuda") is fake
    proxy_cls.assert_called_once_with("qwen", seed=42, device="cuda")
    assert tcls.list_providers() == jcls.list_providers() == ["mystery", "qwen"]
    info = tcls.get_provider_info("qwen")
    assert info.supports_voice_cloning and len(info.builtin_voices) == 9
    assert tcls.get_provider_info("mystery").name == "mystery"
    assert [v.id for v in tcls.list_voices("qwen")] == [v.id for v in jcls.list_voices("qwen")]


def test_factory_import_error_routes_to_isolation(factories):
    import importlib

    _, tcls = factories
    tcls._default_providers_registered = False
    tcls._providers = {}
    tcls._isolated_providers = set()
    real = importlib.import_module

    def failing(name, *a, **k):
        if name == "rho_tts_tpu_torch.providers.qwen":
            raise ImportError("no torch here")
        return real(name, *a, **k)

    with patch("importlib.import_module", side_effect=failing):
        tcls._register_default_providers()
    assert tcls._isolated_providers == {"qwen"}
    assert "qwen" not in tcls._providers and "chatterbox" in tcls._providers
    assert tcls.list_providers() == ["chatterbox", "qwen"]
    assert tcls.get_provider_info("qwen").name == "qwen"


# ---------------------------------------------------------------------------
# A crashed worker is restarted without INIT: the same sequence in both
# ---------------------------------------------------------------------------


class _FakeWorkerProc:
    """A child that answers from a script; it exits with its script when
    ``exits`` (a real worker exits after its last answer), else it is never
    seen to die (a worker hung after closing stdout)."""

    def __init__(self, lines, exits):
        self._lines, self._exits, self.dead = list(lines), exits, False
        self.stdin = MagicMock()
        self.stderr = io.StringIO("")
        self.stdout = self

    def readline(self):
        if self._lines:
            line = self._lines.pop(0)
            self.dead = self._exits and not self._lines
            return line
        self.dead = self._exits
        return ""

    def poll(self):
        return 0 if self.dead else None

    def kill(self):
        self.dead = True

    def wait(self, timeout=None):
        return 0


def _crash_sequence(pkg, exits, calls=5):
    parts = PACKAGES[pkg]
    P = parts["P"]
    spawned = []

    def popen(cmd, **kw):
        if not spawned:  # the first worker: READY, then it dies mid-request
            proc = _FakeWorkerProc([P.encode_message(P.READY, sample_rate=SR)], exits=False)
        else:  # a restarted worker reads a GENERATE first
            proc = _FakeWorkerProc([P.encode_message(
                P.ERROR, message="Expected 'init' as first message")], exits)
        spawned.append(proc)
        return proc

    outcomes = []
    with patch(f"{parts['mod']}.isolation.proxy.VenvManager") as vm, \
            patch("subprocess.Popen", side_effect=popen):
        vm.return_value.ensure_venv.return_value = "/fake/python"
        proxy = parts["proxy"].ProviderProxy("qwen", device="cpu")
        for _ in range(calls):
            try:
                outcomes.append(proxy.generate("x", "/tmp/x.wav"))
            except RuntimeError as e:
                outcomes.append(str(e))
        proxy.close()
    inits = sum(1 for p in spawned for c in p.stdin.write.call_args_list
                if json.loads(c[0][0])["type"] == "init")
    return outcomes, len(spawned), inits


@pytest.mark.parametrize("exits", [True, False], ids=["worker_exits", "worker_hangs"])
def test_restart_without_init_matches_jax(exits):
    ours, ref = _crash_sequence("torch", exits), _crash_sequence("jax", exits)
    assert ours == ref
    outcomes, spawned, inits = ours
    restarted = "Worker crashed and was restarted. Original error: Worker closed stdout (crashed?)"
    no_init = "Worker error: Expected 'init' as first message"
    assert inits == 1  # only the first worker is ever sent INIT
    if exits:
        assert outcomes == [restarted, no_init] + ["Worker is not running"] * 3
        assert spawned == 2
    else:
        assert outcomes == [restarted, no_init, restarted, no_init,
                            "Worker crashed 3 times, giving up"]
        assert spawned == 3
