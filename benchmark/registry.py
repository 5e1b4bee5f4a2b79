"""Finds a cell's files by name, and refuses a cell whose files do not resolve.

* ``cells/<cell>.json``: the configuration's name, the traffic generator's name
  and parameters, the chips, the metrics it reports, the limits of its
  output check, and why it exists;
* ``configs/<config>.json``: one model configuration;
* ``traffic/<generator>.py``: one kind of traffic (``setup``, ``window``, ``judge``);
* ``metrics/<metric>.py``: one metric, a ``read(record)`` that returns a
  number, or None where the run holds nothing for it to read.

Adding a configuration, a cell, a traffic kind or a metric adds files; no
file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CELL_KEYS = {"name", "config", "traffic", "chips", "end_to_end", "per_layer", "limits", "why"}


class CellError(ValueError):
    """A cell, or one of the files it names, is missing or malformed."""


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise CellError(f"{kind} name {name!r} is not a valid name")
    return name


def _json(path: Path) -> Dict:
    if not path.is_file():
        raise CellError(f"{path.relative_to(HERE.parent)} does not exist")
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise CellError(f"{path.relative_to(HERE.parent)} does not exist")
    spec = importlib.util.spec_from_file_location(f"benchmark._loaded.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str) -> Dict:
    cell = _json(HERE / "cells" / f"{_name('cell', name)}.json")
    missing = CELL_KEYS - set(cell)
    if missing:
        raise CellError(f"cell {name}: missing keys {sorted(missing)}")
    if cell["name"] != name:
        raise CellError(f"cells/{name}.json names itself {cell['name']!r}")
    return cell


def load_config(name: str) -> Dict:
    cfg = _json(HERE / "configs" / f"{_name('config', name)}.json")
    if cfg.get("name") != name:
        raise CellError(f"configs/{name}.json names itself {cfg.get('name')!r}")
    return cfg


def load_generator(name: str) -> ModuleType:
    mod = _module(HERE / "traffic" / f"{_name('traffic', name)}.py", f"traffic.{name}")
    for fn in ("setup", "window", "judge"):
        if not callable(getattr(mod, fn, None)):
            raise CellError(f"traffic/{name}.py has no {fn}()")
    return mod


def load_metric(name: str) -> ModuleType:
    mod = _module(HERE / "metrics" / f"{_name('metric', name)}.py", f"metrics.{name}")
    for attr in ("read", "UNIT"):
        if not hasattr(mod, attr):
            raise CellError(f"metrics/{name}.py has no {attr}")
    return mod


def resolve(name: str) -> Dict:
    """Everything a run of cell ``name`` needs, or :class:`CellError`."""
    cell = load_cell(name)
    return {
        "cell": cell,
        "config": load_config(cell["config"]),
        "generator": load_generator(cell["traffic"]["generator"]),
        "end_to_end": {m: load_metric(m) for m in cell["end_to_end"]},
        "per_layer": {m: load_metric(m) for m in cell["per_layer"]},
    }
