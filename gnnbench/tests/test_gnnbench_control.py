"""The comparison that decides ``correct`` fails its control and the
faults a cell can have, and passes the program."""
import pytest
import torch

from gnnbench import cell as C
from gnnbench import control
from gnnbench import run as R
from gnnbench.reference.common import round_to_tf32

CELLS = [w["name"] for w in C.load_benchmark()["workloads"]]
CPU = torch.device("cpu")


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0 - 2 ** -12])
    assert round_to_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -3.0]


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_fails_the_limit(name, small):
    cell = small(C.load_cell(name))
    limit = cell.limits["max_rel_err"]["limit"]
    readings = [control.control_readings(cell, seed, CPU, 1.0)["max_rel_err"]
                for seed in (1, 2, 3)]
    assert min(readings) > limit, readings


# Each fault acts on the units a loop produces: one whole-graph pass
# (PipelinedRunner._run's output), or the requests of a served batch
# (InferenceServer._run_group's outputs); each unit is (output, input x).

def _alter_one_answer(units):
    out, _ = units[len(units) // 2]
    o = out.clone()
    o[o.shape[0] // 2] += 0.01 * o.abs().max()
    return [o if k == len(units) // 2 else u[0] for k, u in enumerate(units)]


def _leave_out_half(units):
    if len(units) == 1:
        o = units[0][0].clone()
        o[o.shape[0] // 2:] = 0.0
        return [o]
    return [u[0] if k < len(units) // 2 else torch.zeros_like(u[0])
            for k, u in enumerate(units)]


def _return_the_input(units):
    return [x.to(out.dtype).reshape(out.shape) if x.shape == out.shape else out * 0
            for out, x in units]


@pytest.mark.parametrize("fault", [_alter_one_answer, _leave_out_half, _return_the_input])
@pytest.mark.parametrize("name", ["gcn2-dblp-whole", "gat2-subgraph-open"])
def test_a_broken_program_is_not_correct(name, fault, small, monkeypatch):
    from repro_torch.core.pipeline import PipelinedRunner
    from repro_torch.serve.engine import InferenceServer

    cell = small(C.load_cell(name))
    if cell.traffic["loop"] == "whole_graph":
        run = PipelinedRunner._run

        def broken(self, inputs, params, *operands):
            outs = run(self, inputs, params, *operands)
            return fault([(outs[0], inputs["x"])]) + outs[1:]

        monkeypatch.setattr(PipelinedRunner, "_run", broken)
    else:
        group = InferenceServer._run_group

        def broken(self, graphs, inputs, params):
            outs = group(self, graphs, inputs, params)
            got = fault([(o[0], torch.as_tensor(i["x"], device=o[0].device))
                         for o, i in zip(outs, inputs)])
            return [[g] + o[1:] for g, o in zip(got, outs)]

        monkeypatch.setattr(InferenceServer, "_run_group", broken)
    res = R.execute(cell, 77, 1.0, False, CPU, t0=0.0)
    assert res["correct"] is False, res["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = C.load_cell(name)
    limit = cell.limits["max_rel_err"]["limit"]
    seconds = C.load_benchmark()["run_seconds"]
    for seed in (101, 102, 103):
        r = control.control_readings(cell, seed, torch.device("cuda"), seconds)
        assert r["max_rel_err"] > limit, (seed, r)
