"""The reader of ``src_compute_rows.pass``: a traced CPU run of each
whole-graph cell reports the rows its source blocks ran over per vertex,
a program without the counter (or without the recorder) gives nothing and
raises nothing."""
import sys

import pytest
import torch

from gnnbench import cell as C
from gnnbench import run as R
from gnnbench import spanread

CPU = torch.device("cpu")
NAME = "src_compute_rows.pass"


def _reader():
    return C.import_file(C.HERE / "metrics" / f"{NAME}.py")


@pytest.mark.parametrize("workload", ["gcn2-dblp-whole", "gat2-dblp-whole"])
def test_a_traced_whole_graph_run_counts_computed_source_rows(workload, small):
    cell = small(C.load_cell(workload))
    assert NAME in {m.name for m in cell.per_layer}
    res = R.execute(cell, 2**31 + 7, 1.0, True, CPU, t0=0.0)
    assert res["correct"]
    got = res["metrics"][NAME]["value"]
    c = spanread.export()["counters"]
    assert got == c["runner.src_rows_computed"] / c["runner.vertices"]
    # two layers, each source block's new nodes once over the flat store,
    # fewer rows than the padded slots the operand gathers walk
    assert got == 2.0
    assert res["metrics"]["src_rows.pass"]["value"] > got


def test_a_program_without_the_counter_gives_nothing(monkeypatch):
    monkeypatch.setattr(spanread, "export", lambda: {
        "spans": [], "counters": {"runner.src_rows_padded": 12,
                                  "runner.vertices": 4}})
    assert _reader().read({}) is None


def test_without_the_recorder_the_reader_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)   # import fails
    assert _reader().read({}) is None
