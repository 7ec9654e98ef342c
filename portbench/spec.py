"""Finding the parts of a cell by name.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), their configurations and metrics. Under ``portbench/``, a
cell's configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json``, the limits of its correctness check
``checks/<cell>.json``, its configuration's program ``programs/<name>.py``
(the traffic's ``program`` where it names one, else the configuration's:
what drives the port's entry point, keeps what the check judges and works
out the check's numbers) and its plain
reference ``reference/<name>.py`` (the configuration's ``reference``); each metric, end-to-end or per-layer, is read by
``metrics/<metric>.py``, which declares the metric's unit (and a per-layer
metric's layer and the end-to-end metric it moves) as ``BENCHMARK.json``
does. A cell reports the end-to-end metrics whose entry has no
``workloads`` key or names it, and with ``--trace 1`` the per-layer metrics
that name it (or, without the key, move a metric it reports).
"""

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class SpecError(ValueError):
    """A name that BENCHMARK.json or the benchmark's folders do not hold,
    or a part that disagrees with BENCHMARK.json."""


@dataclass
class Metric:
    name: str
    unit: str
    read: object  # read(run) -> float or None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _part(root: Path, folder: str, name: str, suffix: str) -> Path:
    if not _NAME.fullmatch(name):
        raise SpecError(f"not a name: {name!r}")
    path = root / "portbench" / folder / f"{name}{suffix}"
    if not path.is_file():
        raise SpecError(f"no {folder} file named {name!r} ({path})")
    return path


def _module(root: Path, folder: str, name: str):
    path = _part(root, folder, name, ".py")
    spec = importlib.util.spec_from_file_location(f"portbench.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference(name: str, root: Path = ROOT):
    """The plain reference module ``reference/<name>.py``."""
    return _module(root, "reference", name)


def program(name: str, root: Path = ROOT):
    """The program module ``programs/<name>.py``."""
    return _module(root, "programs", name)


def metric(entry: dict, root: Path = ROOT) -> Metric:
    """The metric of a BENCHMARK.json entry with its reader, which has to
    declare what the entry says."""
    module = _module(root, "metrics", entry["name"])
    for key in ("unit", "layer", "moves"):
        if key in entry and getattr(module, key.upper(), None) != entry[key]:
            raise SpecError(f"metrics/{entry['name']}.py declares {key} "
                            f"{getattr(module, key.upper(), None)!r}, BENCHMARK.json {entry[key]!r}")
    return Metric(entry["name"], entry["unit"], module.read)


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"no BENCHMARK.json at {root}")
    return _json(path)


def _applies(entry: dict, cell: str, default: bool) -> bool:
    return cell in entry["workloads"] if "workloads" in entry else default


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of BENCHMARK.json with every part loaded."""
    bench = benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SpecError(f"BENCHMARK.json has no workload named {name!r}")
    w = entries[0]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, True)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, m["moves"] in reported)]
    return Cell(
        name, int(w["chips"]),
        _json(_part(root, "configs", w["config"], ".json")),
        _json(_part(root, "traffic", w["traffic"], ".json")),
        _json(_part(root, "checks", name, ".json")),
        [metric(m, root) for m in e2e], [metric(m, root) for m in layer], root)
