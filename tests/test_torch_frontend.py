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
    "serve/signature.py", "serve/cache.py",
    "distributed/fault.py", "runtime_flags.py",
)

# the port's serving tier, no longer a copy: its own spans and clock
# (`repro_torch.spans`) and docstrings, and no `ServeMetrics.write`; the
# reference's public API otherwise
OWN_SERVING = {"serve/metrics.py": {"ServeMetrics.write"}, "serve/server.py": set()}


# copies whose module docstring says what the module means in the port
OWN_DOCSTRING = ("runtime_flags.py",)


def _without_docstring(text: str) -> str:
    import ast
    doc = ast.get_docstring(ast.parse(text), clean=False)
    start = text.index('"""')
    end = text.index('"""', start + 3) + 3
    assert doc is not None and text[start + 3:end - 3] == doc
    return text[:start] + text[end:]


@pytest.mark.parametrize("path", COPIED)
def test_copied_modules_equal_the_reference(path):
    """A copy differs from the reference only in the package name (and,
    for ``OWN_DOCSTRING``, in its module docstring, which says what the
    module means in the port: the code stays byte for byte the same)."""
    port = (ROOT / "src" / "repro_torch" / path).read_text().replace("repro_torch", "repro")
    ref = (ROOT / "src" / "repro" / path).read_text()
    if path in OWN_DOCSTRING:
        port, ref = _without_docstring(port), _without_docstring(ref)
    assert port == ref


def _public_api(text: str) -> dict:
    """Top-level public functions and classes, and the public methods of
    the classes, each with its argument names."""
    import ast

    def args(f):
        a = f.args
        return tuple(x.arg for x in a.posonlyargs + a.args + a.kwonlyargs)

    out = {}
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = args(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = tuple(b.id for b in node.bases if isinstance(b, ast.Name))
            for f in node.body:
                if isinstance(f, ast.FunctionDef) and (
                        not f.name.startswith("_") or f.name == "__init__"):
                    out[f"{node.name}.{f.name}"] = args(f)
    return out


@pytest.mark.parametrize("path", sorted(OWN_SERVING))
def test_own_serving_modules_keep_the_references_api(path):
    """The serving modules the port instruments keep the reference's
    public functions, classes and methods, argument for argument, less
    the ones the port dropped."""
    port = _public_api((ROOT / "src" / "repro_torch" / path).read_text())
    ref = _public_api((ROOT / "src" / "repro" / path).read_text())
    dropped = OWN_SERVING[path]
    assert dropped <= set(ref) and not dropped & set(port)
    assert port == {k: v for k, v in ref.items() if k not in dropped}


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
            "repro_torch.launch.autotune, repro_torch.launch.train_gnn, "
            "repro_torch.analyze, repro_torch.runtime_flags, "
            "repro_torch.distributed.compression, repro_torch.core.exchange\n"
            # a 2-shard pass on the CPU loads nothing of jax or repro either
            "from repro_torch.core import compiler, pipeline, tiling\n"
            "from repro_torch.gnn import graphs, models\n"
            "g = graphs.random_graph(60, 240, seed=0)\n"
            "tr = models.trace_stacked('gcn', 2, 8, 8, 8)\n"
            "out = pipeline.run_sharded(compiler.compile_gnn(tr), g, "
            "tiling.grid_tile(g, 4, 4, sparse=True), models.init_inputs(tr, g), "
            "models.init_params(tr), n_devices=2, devices=['cpu'] * 2, "
            "device='cpu')\n"
            "assert out[0].shape == (60, 8)\n"
            # and so does a one-rank gloo group mesh: a pass, compressed_psum
            "import tempfile, torch, torch.distributed as dist\n"
            "from repro_torch.core.exchange import ShardMesh\n"
            "from repro_torch.distributed.compression import compressed_psum\n"
            "dist.init_process_group('gloo', store=dist.FileStore("
            "tempfile.mktemp(), 1), rank=0, world_size=1)\n"
            "mesh = ShardMesh.from_process_group(device='cpu')\n"
            "out = pipeline.run_sharded(compiler.compile_gnn(tr), g, "
            "tiling.grid_tile(g, 4, 4, sparse=True), models.init_inputs(tr, g), "
            "models.init_params(tr), mesh=mesh)\n"
            "assert out[0].shape == (60, 8) and mesh.collectives == 2\n"
            "compressed_psum([{'g': torch.ones(3)}], mesh, 'shards')\n"
            "dist.destroy_process_group()\n"
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
