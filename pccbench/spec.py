"""What one cell is: its entry in ``BENCHMARK.json`` and the data files
that the entry names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in files of its own, found by name:

- ``pccbench/configs/<config>.json``: the deployment (content shape,
  coding condition, frames);
- ``pccbench/traffic/<traffic>.json``: the mix, parameters that the
  one general loop of ``window.py`` reads (which streams are coded,
  which sides are timed, closed loop or arrivals at a rate);
- ``pccbench/metrics/<metric>.py``: a reader with ``read(run)`` that
  returns the metric's value, or None where it finds nothing to read;
- ``pccbench/codecs/<codec>.py``: the system under test, named by the
  configuration's ``"codec"`` (``octree_raht_fp`` where it names none);
  ``make(cfg, mix, devices, clock)`` returns an object with
  ``encode(codes, values)`` and ``decode(geom, attr, points)``, and
  ``SPAN_NAMES`` lists the spans it opens beside the window's and the
  sides' (``codec.py`` has the interface);
- ``pccbench/checks/<check>.py``: how the attribute outputs are judged,
  named by the configuration's ``"check"`` (``raht_fp`` where it names
  none): ``LIMITS``, ``outputs``, ``reference``, ``numbers`` and the
  controls' ``controls`` (``check.py`` has the geometry's, which every
  cell shares).

A cell added to ``BENCHMARK.json`` with its files runs with no edit here.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

from .window import Mix

PACKAGE_DIR = Path(__file__).resolve().parent
ROOT = PACKAGE_DIR.parent
DEFAULT_CODEC = "octree_raht_fp"
DEFAULT_CHECK = "raht_fp"


def load_file(root: Path, kind: str, name: str):
    """The module ``pccbench/<kind>/<name>.py`` under ``root``, loaded by
    file, so that a root of its own (a test's) can hold its own."""
    path = Path(root) / "pccbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"pccbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]]

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    mix: Mix
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path

    def reader(self, metric: str) -> Callable:
        """The metric's ``read`` function, loaded by file."""
        return load_file(self.root, "metrics", metric).read

    def codec(self):
        """The module of the configuration's codec."""
        return load_file(self.root, "codecs",
                         self.config.get("codec", DEFAULT_CODEC))

    def check(self):
        """The module of the configuration's attribute check."""
        return load_file(self.root, "checks",
                         self.config.get("check", DEFAULT_CHECK))


def _metrics(entries) -> List[Metric]:
    return [Metric(e["name"], e["unit"], e["better"], e["source"],
                   e.get("workloads")) for e in entries]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload``; KeyError when BENCHMARK.json has none."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    config_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    config = json.loads((root / config_file).read_text())
    mix = Mix.from_data(json.loads(
        (root / "pccbench" / "traffic" / f"{w['traffic']}.json").read_text()))
    e2e = [m for m in _metrics(bench["end_to_end"]) if m.applies(workload)]
    layer = [m for m in _metrics(bench["per_layer"]) if m.applies(workload)]
    return Cell(workload, int(w["chips"]), w["config"], w["traffic"], config,
                mix, e2e, layer, root)
