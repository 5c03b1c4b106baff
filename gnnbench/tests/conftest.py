"""CPU tests of the benchmark harness: ``python -m pytest gnnbench/tests``.

Tests that need a CUDA card carry the ``chip`` marker and decide inside
the test whether one is visible.
"""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def small(monkeypatch):
    """Shrink a cell to CPU sizes: the DBLP stand-in to 3,000 vertices,
    the served requests to 2-4 seeds each at 20 requests a second."""
    from gnnbench import graphgen
    monkeypatch.setitem(graphgen.PAPER_DATASETS, "coAuthorsDBLP", (3000, 12000, "powerlaw"))

    def shrink(cell):
        if cell.traffic["loop"] == "open_loop":
            cell.traffic.update(seeds_per_request=[2, 4],
                                rate_per_s={k: 20.0 for k in cell.traffic["rate_per_s"]})
        return cell
    return shrink
