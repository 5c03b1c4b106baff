"""The port's copied numpy front end lowers every model exactly as `repro`
does, and importing the port never loads `jax` or anything of `repro`."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import compiler as jcompiler
from repro.core import tiling as jtiling
from repro.gnn import graphs as jgraphs
from repro.gnn import models as jmodels
from repro.serve import signature as jsig
from repro_torch.core import compiler as tcompiler
from repro_torch.core import tiling as ttiling
from repro_torch.gnn import graphs as tgraphs
from repro_torch.gnn import models as tmodels
from repro_torch.serve import signature as tsig

ROOT = Path(__file__).resolve().parents[1]
MODELS = ("gcn", "gat", "sage", "ggnn", "rgcn", "gin")


def _trace(M, name, n_layers, dim=16):
    if n_layers == 1:
        return M.trace_named(name, dim, dim)
    return M.trace_stacked(name, n_layers, dim, dim, dim)


@pytest.mark.parametrize("layout", ["coo", "csr"])
@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("name", MODELS)
def test_same_program_and_tiles(name, n_layers, layout):
    jc = jcompiler.compile_gnn(_trace(jmodels, name, n_layers))
    tc = tcompiler.compile_gnn(_trace(tmodels, name, n_layers))
    for dispatch in (True, False):
        assert (tc.structure_signature(dispatch)
                == jc.structure_signature(dispatch))
    assert tc.opt_report == jc.opt_report

    etypes = 3 if jmodels.MODELS[name].needs_etype else None
    jg = jgraphs.random_graph(70, 300, seed=4, n_edge_types=etypes)
    tg = tgraphs.random_graph(70, 300, seed=4, n_edge_types=etypes)
    np.testing.assert_array_equal(tg.src, jg.src)
    jt, jro = jtiling.build_tiles(jg, 3, 4, layout=layout, reorder="degree")
    tt, tro = ttiling.build_tiles(tg, 3, 4, layout=layout, reorder="degree")
    assert tt.shape_signature() == jt.shape_signature()
    np.testing.assert_array_equal(tro.order, jro.order)
    for field in ("src_ids", "edge_src", "edge_dst", "edge_gid", "part_id"):
        np.testing.assert_array_equal(getattr(tt, field), getattr(jt, field))
    if layout == "csr":
        np.testing.assert_array_equal(tt.row_ptr, jt.row_ptr)

    jp = jmodels.init_params(jc.trace, seed=2)
    tp = tmodels.init_params(tc.trace, seed=2)
    assert jp.keys() == tp.keys()
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])


def test_serving_registry_and_signature_match():
    gs = [jgraphs.random_graph(48, 200, seed=s, model="powerlaw")
          for s in range(5)]
    jb = jgraphs.batch_graphs(gs)
    tb = tgraphs.batch_graphs([tgraphs.Graph(g.src, g.dst, g.n_vertices)
                               for g in gs])
    jreg, treg = jsig.ShapeRegistry(), tsig.ShapeRegistry()
    _, jts, jE, _ = jreg.canonical("k", jb.graph)
    _, tts, tE, _ = treg.canonical("k", tb.graph)
    assert (tts.shape_signature(), tE) == (jts.shape_signature(), jE)
    jc = jcompiler.compile_gnn(jmodels.trace_named("gcn", 16, 16))
    tc = tcompiler.compile_gnn(tmodels.trace_named("gcn", 16, 16))
    assert (tsig.structure_signature(tc, tts, tE)
            == jsig.structure_signature(jc, jts, jE))
    bt_j = jtiling.bucket_tiles(jts, 3)
    bt_t = ttiling.bucket_tiles(tts, 3)
    assert bt_t.shape_signature() == bt_j.shape_signature()


# every module the port keeps as a verbatim copy of the reference's
COPIED = (
    "gnn/graphs.py", "gnn/models.py", "gnn/frontend.py",
    "core/ir.py", "core/trace.py", "core/passes.py", "core/compiler.py",
    "core/schedule.py", "core/reorder.py", "core/tiling.py", "core/isa.py",
    "core/streams.py", "core/simulator.py",
    "core/analysis/__init__.py", "core/analysis/diagnostics.py",
    "core/analysis/ir_verifier.py", "core/analysis/schedule_verifier.py",
    "core/analysis/hazards.py", "analyze.py",
    "serve/signature.py", "serve/cache.py", "serve/metrics.py",
    "serve/server.py",
)


@pytest.mark.parametrize("path", COPIED)
def test_copied_modules_equal_the_reference(path):
    """A copy differs from the reference only in the package name."""
    port = (ROOT / "src" / "repro_torch" / path).read_text()
    ref = (ROOT / "src" / "repro" / path).read_text()
    assert port.replace("repro_torch", "repro") == ref


def test_analysis_sweep_matches_reference():
    """`analyze.analyze_matrix` (IR, both schedules, exchange census and
    the stream-task hazard passes) reports exactly what the reference's
    does over the paper models at 1 and 2 layers."""
    from repro import analyze as janalyze
    from repro_torch import analyze as tanalyze

    args = (["gcn", "gat", "sage", "ggnn", "rgcn"], [1, 2], 16, True)
    got = tanalyze.analyze_matrix(*args)
    want = janalyze.analyze_matrix(*args)
    assert {k: [d.format() for d in v] for k, v in got.items()} == \
        {k: [d.format() for d in v] for k, v in want.items()}


def test_import_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.serve, "
            "repro_torch.core.pipeline, repro_torch.kernels.segment_softmax, "
            "repro_torch.configs, repro_torch.convert, repro_torch.models.lm, "
            "repro_torch.launch.serve, repro_torch.launch.steps, "
            "repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.moe_dispatch.ops, repro_torch.serve.server, "
            "repro_torch.launch.autotune, repro_torch.analyze\n"
            "bad = [m for m in sys.modules if m.startswith('jax') "
            "or m == 'repro' or m.startswith('repro.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_of_the_port_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pattern.search(f.read_text())]
    assert len(files) > 20 and not offenders, offenders
