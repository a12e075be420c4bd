"""The benchmark's own CPU tests (``python -m pytest pccbench/tests``).

They sit apart from the repository's ``tests/`` and import no JAX.  A
test that needs the card carries ``@pytest.mark.cuda`` and skips itself
without one.  ``tiny_root`` is a copy of the benchmark, with its
configurations cut to a few thousand points, in which a whole run takes
a second on the CPU.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"vox10_body": {"bits": 7, "frames": 2},
        "lidar_hdl64": {"lasers": 8, "azimuth_steps": 64, "frames": 3}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; the test skips itself without "
        "one")


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch
    torch.set_num_threads(2)


def make_tiny_root(dst: Path) -> Path:
    """A copy of BENCHMARK.json and pccbench/ under ``dst`` with every
    configuration cut to a tiny size."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "pccbench", dst / "pccbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, cut in TINY.items():
        path = dst / "pccbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(cut)
        path.write_text(json.dumps(cfg))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
