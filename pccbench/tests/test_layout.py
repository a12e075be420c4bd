"""BENCHMARK.json keeps the benchmark's contract, and every name in it
finds its files: a configuration, a traffic mix, a metric reader."""

import json
import re
from pathlib import Path

import pytest

from pccbench.window import Mix

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(map(_line, BENCH["command"]))
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            if "better" in e:
                assert e["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    metric_names = [e["name"] for g in ("end_to_end", "per_layer")
                    for e in BENCH[g]]
    assert len(set(metric_names)) == len(metric_names)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("pccbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
            assert not re.search(r"(_dim|_rank)$", k)


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        Mix.from_data(json.loads(
            (ROOT / "pccbench" / "traffic" / f"{w['traffic']}.json")
            .read_text()))
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def _cells_of(metric):
    return metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_end_to_end():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(_cells_of(m)) <= cells
    for cell in cells:
        mine = [m for m in BENCH["end_to_end"] if cell in _cells_of(m)]
        assert len(mine) >= 2
        assert any(cell in _cells_of(m) for m in BENCH["per_layer"])


def test_per_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        # every cell the metric lists reports the metric it moves
        assert set(_cells_of(m)) <= set(_cells_of(e2e[m["moves"]]))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("name", [m["name"] for g in ("end_to_end",
                                                      "per_layer")
                                  for m in BENCH[g]])
def test_every_metric_has_a_reader(name):
    path = ROOT / "pccbench" / "metrics" / f"{name}.py"
    assert path.is_file()
    assert "def read(run)" in path.read_text()


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_configuration_finds_its_codec_and_check(config):
    """A configuration names its codec and check, or takes the
    defaults; each is a file with the interface ``run.py`` calls."""
    from pccbench import spec
    cell = spec.load_cell(next(w["name"] for w in BENCH["workloads"]
                               if w["config"] == config), root=ROOT)
    codec = cell.codec()
    assert callable(codec.make)
    assert all(NAME.match(n) for n in getattr(codec, "SPAN_NAMES", ()))
    chk = cell.check()
    assert all(callable(getattr(chk, f)) for f in
               ("outputs", "reference", "numbers", "controls"))
    assert chk.LIMITS and all(NAME.match(k) for k in chk.LIMITS)
