"""The manifest and everything it names, found by name, within the
benchmark contract's limits: ``BENCHMARK.json``, and the same with the
four-card cell's entries (``data/four_card_cell.json``) added, as a
manifest that lists the cell will have them."""

import json
import re
import shutil

import pytest

from perfbench import cells
from perfbench_helpers import with_four_card_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion)")


@pytest.fixture(scope="module", params=["BENCHMARK.json", "with the four-card cell"])
def man(request):
    if request.param == "BENCHMARK.json":
        return cells.manifest()
    return with_four_card_cell(cells.manifest())


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= len(man["paths"]) <= 16 and all(PATH.match(p) for p in man["paths"])
    for word in man["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man)) <= 64 * 1024


def test_check_fits_with_24_cells(man):
    runs = 2 + 14 * 24
    assert runs * (man["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_found_by_name(man):
    names = [c["name"] for c in man["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        spec = cells.load_json("configs", c["name"])
        assert spec["name"] == c["name"] and spec["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert spec["order"] in (2, 6)
        used = [w for w in man["workloads"] if w["config"] == c["name"]]
        assert used, f"configuration {c['name']} has no cell"


def test_workloads_found_by_name(man):
    names = [w["name"] for w in man["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in man["workloads"]) <= max(1, len(names) // 4)
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        cell = cells.load_cell(w["name"], man)
        assert cell["dtype"] in ("float32", "float64")
        assert cell["pool"] >= 1 and cell["trace_solves"] >= 1
        assert cell["limits"] and set(cell["limits"]) <= {"residual", "error", "residual_gap"}
        assert all(0 < v < 1 for v in cell["limits"].values())
        if "rtol" in cell:
            # the configuration states the residual's limit: the cell's rtol
            assert cell["limits"]["residual"] == cell["rtol"]


def test_cells_on_more_than_one_card(man):
    """A cell with chips over 1 agrees with its traffic file and splits its
    configuration's process grid over exactly its cards; at most a quarter
    of the cells, rounded down, ask for four (one always may); and every
    metric of the four-card cells ("dist_*", "*.dist") lists only them."""
    multi = [w for w in man["workloads"] if w["chips"] > 1]
    assert len(multi) <= max(1, len(man["workloads"]) // 4)
    for w in multi:
        cell = cells.load_cell(w["name"], man)
        assert cell["chips"] == w["chips"] == 4
        spec = cell["config_spec"]
        assert len(spec["pgrid"]) == 3 and spec["pgrid"][0] * spec["pgrid"][1] * spec["pgrid"][2] \
            == w["chips"]
        assert spec["backend"] == "nccl"
        assert all(n % p == 0 for n, p in zip(cell["grid"], spec["pgrid"]))
    for w in man["workloads"]:
        if w["chips"] == 1:
            assert "pgrid" not in cells.load_cell(w["name"], man)["config_spec"]
    four = {w["name"] for w in multi}
    dist = [m for m in man["end_to_end"] + man["per_layer"]
            if m["name"].startswith("dist_") or m["name"].endswith(".dist")]
    assert bool(dist) == bool(multi)
    for m in dist:
        assert m["workloads"] and set(m["workloads"]) <= four, m["name"]


def test_metrics_found_by_name_and_reported_with_what_they_move(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    layers = {m["name"]: m for m in man["per_layer"]}
    assert "setup_s" in e2e and not set(e2e) & set(layers)
    cellnames = {w["name"] for w in man["workloads"]}
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cellnames)) <= cellnames
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(cells.reader(m["name"]))
    for m in man["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cellnames))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cellnames:
        assert [m for m in man["end_to_end"] if m["name"] != "setup_s"
                and w in m.get("workloads", cellnames)]
        assert [m for m in man["per_layer"] if w in m["workloads"]]


def test_a_dropped_in_cell_is_found_without_editing(tmp_path, monkeypatch):
    for kind in ("configs", "workloads"):
        shutil.copytree(cells.HERE / kind, tmp_path / kind)
    new = json.loads((tmp_path / "workloads" / "poisson7.64.f64.json").read_text())
    new["grid"] = [96, 96, 96]
    (tmp_path / "workloads" / "poisson7.96.f64.json").write_text(json.dumps(new))
    monkeypatch.setattr(cells, "HERE", tmp_path)
    cell = cells.load_cell("poisson7.96.f64")
    assert cell["grid"] == [96, 96, 96] and cell["config_spec"]["order"] == 2
    man = cells.manifest()
    man["workloads"].append({"name": "poisson7.96.f64", "config": "poisson7_mgcg",
                             "traffic": "poisson7.96.f64", "chips": 1, "why": "a test"})
    assert cells.load_cell("poisson7.96.f64", man)["grid"] == [96, 96, 96]


def test_manifest_and_traffic_file_must_agree(man):
    bad = json.loads(json.dumps(man))
    bad["workloads"][0]["chips"] = 4
    with pytest.raises(ValueError):
        cells.load_cell(bad["workloads"][0]["name"], bad)
    with pytest.raises(FileNotFoundError):
        cells.load_cell("no.such.cell", man)
    with pytest.raises(FileNotFoundError):
        cells.reader("no_such_metric")
