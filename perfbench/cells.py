"""Everything of the benchmark found by name: the manifest
(``BENCHMARK.json`` at the root of the checkout), a cell's traffic file
(``perfbench/workloads/<traffic>.json``), a configuration's file
(``perfbench/configs/<config>.json``) and a metric's reader
(``perfbench/metrics/<metric>.py``, a function ``read(record)`` that
returns a number, or None where the record holds nothing to read). A
metric ``<base>.<variant>`` without a file of its own, the same quantity
under a name of its own for cells that move another end-to-end metric,
is read by ``<base>``'s reader.

A later cell, configuration or metric is a new file and a new entry of
the manifest: no code here names one.
"""

from __future__ import annotations

import importlib.util
import json
from functools import lru_cache
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def manifest(path: Path = MANIFEST) -> dict:
    with open(path) as fh:
        return json.load(fh)


def manifest_entry(name: str, man: Optional[dict]) -> Optional[dict]:
    """The manifest's entry of the cell `name`, None where it has none."""
    if man is None:
        return None
    return next((w for w in man["workloads"] if w["name"] == name), None)


def load_json(kind: str, name: str) -> dict:
    """``perfbench/<kind>/<name>.json``: `kind` is configs or workloads."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path} is missing)")
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, man: Optional[dict] = None) -> dict:
    """The cell `name` as one dict: its traffic file, with its
    configuration under "config_spec". The manifest, where it lists the
    cell, names the traffic file and must agree on the configuration and
    the chips; a cell it does not list is found by its traffic file
    alone."""
    entry = manifest_entry(name, man)
    traffic = entry["traffic"] if entry else name
    cell = load_json("workloads", traffic)
    if entry is not None:
        for key in ("config", "chips"):
            if cell[key] != entry[key]:
                raise ValueError(f"cell {name!r}: {key} {cell[key]!r} in its traffic file, "
                                 f"{entry[key]!r} in the manifest")
    cell = dict(cell, name=name)
    cell["config_spec"] = load_json("configs", cell["config"])
    return cell


def metrics_for(cell: str, man: dict, trace: bool) -> list[dict]:
    """The manifest's metrics that this cell reports: the end-to-end ones
    in a run without the trace, the per-layer ones in a traced run; a
    metric with a "workloads" list only in those cells."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


@lru_cache(maxsize=None)
def metric_module(metric: str):
    """The module ``perfbench/metrics/<metric>.py`` (its reader and any
    name table or byte model it holds), or its base's."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file() and "." in metric:
        return metric_module(metric.rsplit(".", 1)[0])
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``perfbench/metrics/<metric>.py``."""
    return metric_module(metric).read


def read_metrics(metrics: list[dict], record: dict) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read in `record`."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
