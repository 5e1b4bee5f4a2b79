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
* the console script ``rho-tts-tpu-torch-ui`` names the port's UI.
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
