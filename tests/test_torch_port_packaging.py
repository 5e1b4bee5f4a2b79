"""The port's package root and its boundary with the JAX package.

* ``rho_tts_tpu_torch.__all__`` is the JAX package's list, ``launch_ui``
  and ``train_drift_classifier`` included; ``launch_ui`` imports without
  gradio; ``train_drift_classifier`` forwards its four arguments to the
  port's trainer;
* every module of the port imports cleanly, the new ``isolation`` and
  ``ui`` ones too;
* a source scan finds no import of JAX (``jax``, ``jaxlib``, ``optax``,
  ``flax``, ``orbax``) and none of ``rho_tts_tpu`` as a package anywhere
  under ``src/rho_tts_tpu_torch/``, in ``chip_smoke.py`` or in
  ``examples/torch/``;
* the console script ``rho-tts-tpu-torch-ui`` names the port's UI;
* every port test file bounds its waits: one that imports torch pins torch
  to one intra-op thread at import (or through the module-scoped
  ``one_torch_thread`` fixture), and each call that starts a child process
  passes a ``timeout=`` (children start through ``subprocess.run``,
  ``start_world`` or ``run_dryrun``; a bare ``Popen`` or ``Process`` has no
  bound and is refused). A file that imports no torch (a pure scan, as this
  one) needs no pin.
"""

import ast
import importlib
import pkgutil
import re
import sys
from pathlib import Path
from unittest.mock import patch

import pytest

import rho_tts_tpu
import rho_tts_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "rho_tts_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "orbax", "rho_tts_tpu"}


def test_all_equals_jax():
    assert rho_tts_tpu_torch.__all__ == rho_tts_tpu.__all__
    for name in rho_tts_tpu_torch.__all__:
        assert hasattr(rho_tts_tpu_torch, name), name
    parts = rho_tts_tpu_torch.__version__.split(".")
    assert len(parts) == 3 and all(p.isdigit() for p in parts)


def test_launch_ui_needs_gradio_only_when_called(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    assert callable(rho_tts_tpu_torch.launch_ui)
    with pytest.raises(ImportError):
        rho_tts_tpu_torch.launch_ui()


def test_train_drift_classifier_forwards_to_the_ports_trainer():
    cb = print
    with patch("rho_tts_tpu_torch.validation.classifier.trainer.train",
               return_value="/m.pkl") as train:
        out = rho_tts_tpu_torch.train_drift_classifier("/data", voice_id="v",
                                                       output_path="/m.pkl",
                                                       progress_callback=cb)
    assert out == "/m.pkl"
    train.assert_called_once_with(dataset_dir="/data", voice_id="v", output_path="/m.pkl",
                                  progress_callback=cb)


def _port_modules():
    return sorted(info.name for info in pkgutil.walk_packages([str(PORT)],
                                                              prefix="rho_tts_tpu_torch."))


@pytest.mark.parametrize("name", _port_modules())
def test_every_port_module_imports(name):
    importlib.import_module(name)


def test_new_layers_are_among_the_modules():
    mods = set(_port_modules())
    for name in ("isolation", "isolation.protocol", "isolation.worker", "isolation.procman",
                 "isolation.proxy", "isolation.venvs", "ui", "ui.app", "ui.callbacks",
                 "ui.config", "ui.session", "ui.state", "utils.profiling"):
        assert f"rho_tts_tpu_torch.{name}" in mods, name
    for main in ("isolation", "ui"):  # imported above without running their loops
        assert f"rho_tts_tpu_torch.{main}.__main__" in mods


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    files += sorted((ROOT / "examples" / "torch").glob("*.py"))
    return files


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value,
                                                                          str):
            yield node.lineno, node.args[0].value


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package_imported(path):
    bad = [(line, name) for line, name in _imports(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_what_it_must_refuse(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom rho_tts_tpu.ui import config\n"
                     "import rho_tts_tpu_torch\nimportlib.import_module('rho_tts_tpu.engine')\n")
    found = [n.split(".")[0] for _, n in _imports(probe)]
    assert [n for n in found if n in FORBIDDEN] == ["jax", "rho_tts_tpu", "rho_tts_tpu"]


def test_console_script_names_the_ports_ui():
    text = (ROOT / "pyproject.toml").read_text()
    assert re.search(r'^rho-tts-tpu-torch-ui = "rho_tts_tpu_torch\.ui:main"$', text, re.M)
    from rho_tts_tpu_torch.ui import main

    assert callable(main)


# ---------------------------------------------------------------------------
# The port's test files bound their waits
# ---------------------------------------------------------------------------

PIN = "torch.set_num_threads(1)"
#: calls that start a child process: each must pass ``timeout=``
CHILD_STARTS = {"run", "call", "check_call", "check_output", "Popen", "Process", "spawn",
                "start_processes", "start_world", "run_dryrun"}
SUBPROCESS_ONLY = {"run", "call", "check_call", "check_output"}  # as ``subprocess.<name>``


def _call_name(node):
    """(owner, name) of a call: ``subprocess.run(...)`` -> ("subprocess", "run")."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return getattr(f.value, "id", None), f.attr
    return None, getattr(f, "id", None)


def _world_internals(tree):
    """The nodes inside ``World``, the one place that starts ranks (bounded by
    ``World.join`` and ``reap_worlds``)."""
    return {id(n) for c in tree.body if isinstance(c, ast.ClassDef) and c.name == "World"
            for n in ast.walk(c)}


def unbounded_waits(path):
    """What ``path`` does that can wait past the suite's clock: a torch
    import without the thread pin, a child start without ``timeout=``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    problems = []
    imports_torch = any(name.split(".")[0] == "torch" for _, name in _imports(path))
    pinned = any(isinstance(n, ast.Expr) and ast.unparse(n) == PIN for n in tree.body)
    fixture = any(isinstance(n, (ast.ImportFrom, ast.FunctionDef)) and "one_torch_thread" in
                  ast.unparse(n) for n in tree.body)
    if imports_torch and not (pinned or fixture):
        problems.append("imports torch without `torch.set_num_threads(1)` at import")
    inside_world = _world_internals(tree)
    for node in sorted(ast.walk(tree), key=lambda n: getattr(n, "lineno", 0)):
        if not isinstance(node, ast.Call) or id(node) in inside_world:
            continue
        owner, name = _call_name(node)
        if name not in CHILD_STARTS or (name in SUBPROCESS_ONLY and owner != "subprocess"):
            continue
        if name in ("Popen", "Process", "spawn", "start_processes") or \
                not any(k.arg == "timeout" for k in node.keywords):
            problems.append(f"line {node.lineno}: {name}() starts a child with no timeout")
    return problems


@pytest.mark.parametrize("path", sorted((ROOT / "tests").glob("test_torch_port_*.py")),
                         ids=lambda p: p.name)
def test_port_test_files_bound_their_waits(path):
    assert unbounded_waits(path) == []


def test_the_wait_scan_sees_what_it_must_refuse(tmp_path):
    bad = tmp_path / "test_torch_port_probe.py"
    bad.write_text("import subprocess\nimport multiprocessing as mp\nimport torch\n"
                   "from test_torch_port_parallel_ranks import start_world\n\n"
                   "def test_x(tmp_path):\n"
                   "    subprocess.run(['true'])\n"
                   "    subprocess.Popen(['true'])\n"
                   "    mp.Process(target=print).start()\n"
                   "    start_world(tmp_path, 2, print)\n"
                   "    subprocess.run(['true'], timeout=5)\n"
                   "    start_world(tmp_path, 2, print, timeout=60)\n"
                   "    ','.join(['a']); run(1); Process\n")
    assert unbounded_waits(bad) == [
        "imports torch without `torch.set_num_threads(1)` at import",
        "line 7: run() starts a child with no timeout",
        "line 8: Popen() starts a child with no timeout",
        "line 9: Process() starts a child with no timeout",
        "line 10: start_world() starts a child with no timeout",
    ]
    good = tmp_path / "test_torch_port_good.py"
    good.write_text("import torch\n\ntorch.set_num_threads(1)  # shared cores\n")
    assert unbounded_waits(good) == []
    fixture = tmp_path / "test_torch_port_fixture.py"
    fixture.write_text("import torch\n"
                       "from test_torch_port_features import one_torch_thread  # noqa: F401\n")
    assert unbounded_waits(fixture) == []
