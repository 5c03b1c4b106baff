"""The reader of ``src_replica_rows.pass``: a traced CPU run of each
whole-graph cell reads 0 (the tile kernels read the flat store, the edge
blocks stored rows by global id), a program without the counter (or
without the recorder) gives nothing and raises nothing."""
import sys

import pytest
import torch

from gnnbench import cell as C
from gnnbench import run as R
from gnnbench import spanread

CPU = torch.device("cpu")
NAME = "src_replica_rows.pass"


def _reader():
    return C.import_file(C.HERE / "metrics" / f"{NAME}.py")


@pytest.mark.parametrize("workload", ["gcn2-dblp-whole", "gat2-dblp-whole"])
def test_a_traced_whole_graph_run_builds_no_source_replica(workload, small):
    cell = small(C.load_cell(workload))
    assert NAME in {m.name for m in cell.per_layer}
    res = R.execute(cell, 2**31 + 11, 1.0, True, CPU, t0=0.0)
    assert res["correct"]
    c = spanread.export()["counters"]
    assert c["runner.src_rows_replicated"] == 0 and c["runner.vertices"] > 0
    assert res["metrics"][NAME]["value"] == 0.0


def test_other_cells_do_not_report_it():
    for workload in ("rgcn2-dblp-rel-whole", "gcn2-subgraph-open"):
        assert NAME not in {m.name for m in C.load_cell(workload).per_layer}


def test_the_reader_divides_the_counter_by_the_vertices(monkeypatch):
    monkeypatch.setattr(spanread, "export", lambda: {
        "spans": [], "counters": {"runner.src_rows_replicated": 30,
                                  "runner.vertices": 4}})
    assert _reader().read({}) == 7.5


def test_a_program_without_the_counter_gives_nothing(monkeypatch):
    monkeypatch.setattr(spanread, "export", lambda: {
        "spans": [], "counters": {"runner.src_rows_padded": 12,
                                  "runner.vertices": 4}})
    assert _reader().read({}) is None


def test_without_the_recorder_the_reader_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)   # import fails
    assert _reader().read({}) is None
