"""The port's plain tile-kernel versions against `repro`'s refs and its
Pallas kernels (interpret mode), on the `test_kernels.py` shapes.

The CUDA kernels themselves run only on a card (`chip_smoke.py` holds each
against these plain versions there); on the CPU the dispatchers in
`repro_torch.kernels.tile_spmm.ops` take the plain versions, and the CUDA
wrappers refuse CPU tensors.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import tiling as jtiling
from repro.gnn import graphs as jgraphs
from repro.kernels.tile_spmm import kernel as jkernel
from repro.kernels.tile_spmm import ops as jops
from repro.kernels.tile_spmm import ref as jref
from repro_torch.core import tiling as ttiling
from repro_torch.gnn import graphs as tgraphs
from repro_torch.kernels import segment_softmax as tsoftmax
from repro_torch.kernels.tile_spmm import kernel as tkernel
from repro_torch.kernels.tile_spmm import ops as tops
from repro_torch.kernels.tile_spmm import ref as tref
from repro_torch.kernels.tile_spmm.plan import LAST, csr_plan

TOL = dict(atol=1e-5, rtol=1e-4)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
SHAPES = [(120, 500, 4, 4, 16), (80, 200, 2, 5, 8), (50, 600, 6, 2, 32)]


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _tiles(V, E, p, s, layout="coo", seed=None):
    g = jgraphs.random_graph(V, E, seed=V if seed is None else seed)
    return g, jtiling.grid_tile(g, p, s, sparse=True, layout=layout)


def _per_edge(ts, per_edge_global, poison=None):
    """(T, E[, F]) per-slot values from global per-edge values; padded
    slots optionally overwritten with ``poison``."""
    out = per_edge_global[ts.edge_gid].astype(np.float32)
    if poison is not None:
        for t in range(ts.n_tiles):
            out[t, int(ts.n_edge[t]):] = poison
    return out


def _whole_graph_softmax(g, s_g, v_g):
    out = np.zeros((g.n_vertices, v_g.shape[1]), np.float64)
    for v in np.unique(g.dst):
        e = np.nonzero(g.dst == v)[0]
        p = np.exp(s_g[e] - s_g[e].max())
        out[v] = (p[:, None] * v_g[e]).sum(0) / p.sum()
    return out


def _by_partition(ts, out, whole, **tol):
    for p in range(ts.n_dst_parts):
        n, lo = int(ts.part_size[p]), int(ts.part_start[p])
        np.testing.assert_allclose(np.asarray(out)[p, :n], whole[lo:lo + n],
                                   **tol)


@pytest.fixture(autouse=True)
def _no_launches():
    """Every test runs the CPU path: no CUDA kernel may launch."""
    tkernel.reset_launches()
    yield
    assert sum(tkernel.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# COO tile SpMM and segment softmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V,E,p,s,F", SHAPES)
def test_tile_spmm_matches_reference_and_pallas(V, E, p, s, F, rng):
    g, ts = _tiles(V, E, p, s)
    x = rng.standard_normal((V, F)).astype(np.float32)
    adj, flags = jops.densify_tiles(ts)
    tadj, tflags = tops.densify_tiles(ttiling.grid_tile(
        tgraphs.random_graph(V, E, seed=V), p, s, sparse=True))
    np.testing.assert_array_equal(tadj, adj)
    np.testing.assert_array_equal(tflags, flags)

    xs = np.asarray(jops.gather_sources(ts, x))
    np.testing.assert_array_equal(tops.gather_sources(ts, _t(x)).numpy(), xs)
    want_ref = jref.tile_spmm_ref(jnp.asarray(adj), xs, jnp.asarray(ts.part_id),
                                  ts.n_dst_parts)
    want_pallas = jkernel.tile_spmm_pallas(
        jnp.asarray(adj), xs, jnp.asarray(ts.part_id), jnp.asarray(flags),
        n_parts=ts.n_dst_parts)
    got = tops.spmm(_t(adj), _t(xs), _t(ts.part_id, torch.int32),
                    _t(flags, torch.int32), n_parts=ts.n_dst_parts).numpy()
    np.testing.assert_allclose(got, np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL)


@pytest.mark.parametrize("V,E,p,s,F", SHAPES + [(90, 400, 3, 3, 12)])
def test_segment_softmax_matches_reference_and_pallas(V, E, p, s, F, rng):
    g, ts = _tiles(V, E, p, s)
    D = int(ts.part_size.max())
    s_g = rng.standard_normal(g.n_edges).astype(np.float32)
    v_g = rng.standard_normal((g.n_edges, F)).astype(np.float32)
    scores_e = _per_edge(ts, s_g)
    vals = _per_edge(ts, v_g)
    jscores = jops.densify_edge_scores(jnp.asarray(scores_e),
                                       jnp.asarray(ts.edge_dst),
                                       jnp.asarray(ts.n_edge), dmax=D)
    tscores = tsoftmax.densify_edge_scores(
        _t(scores_e), _t(ts.edge_dst).long(), _t(ts.n_edge).long(), dmax=D)
    np.testing.assert_array_equal(tscores.numpy(), np.asarray(jscores))

    pid, flags = ts.part_id, jkernel.tile_flags(ts.part_id)
    want_ref = jref.segment_softmax_ref(jscores, jnp.asarray(vals),
                                        jnp.asarray(pid), ts.n_dst_parts)
    want_pallas = jkernel.segment_softmax_pallas(
        jscores, jnp.asarray(vals), jnp.asarray(pid), jnp.asarray(flags),
        n_parts=ts.n_dst_parts)
    got = tsoftmax.gat_aggregate(tscores, _t(vals), _t(pid, torch.int32),
                                 _t(flags, torch.int32),
                                 n_parts=ts.n_dst_parts).numpy()
    np.testing.assert_allclose(got, np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL)
    _by_partition(ts, got, _whole_graph_softmax(g, s_g, v_g), atol=1e-5,
                  rtol=1e-4)


def test_densify_edge_weights_matches_reference(rng):
    g, ts = _tiles(100, 500, 3, 3)
    w = _per_edge(ts, rng.standard_normal(g.n_edges).astype(np.float32),
                  poison=7.0)
    D = int(ts.part_size.max())
    want = jops.densify_edge_weights(
        jnp.asarray(w), jnp.asarray(ts.edge_dst), jnp.asarray(ts.edge_src),
        jnp.asarray(ts.n_edge), dmax=D, smax=ts.s_max)
    got = tops.densify_edge_weights(
        _t(w), _t(ts.edge_dst).long(), _t(ts.edge_src).long(),
        _t(ts.n_edge).long(), dmax=D, smax=ts.s_max)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# CSR tile SpMM and segment softmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V,E,p,s,F", SHAPES)
def test_csr_spmm_matches_reference_and_pallas(V, E, p, s, F, rng):
    g, cs = _tiles(V, E, p, s, layout="csr")
    x = rng.standard_normal((V, F)).astype(np.float32)
    w_g = rng.standard_normal(g.n_edges).astype(np.float32)
    xs = np.asarray(jops.gather_sources(cs, x))
    w = _per_edge(cs, w_g, poison=1e9)   # the JAX refs multiply padding by 0
    flags = jkernel.tile_flags(cs.part_id)
    args = (jnp.asarray(cs.row_ptr), jnp.asarray(cs.edge_src), jnp.asarray(w),
            xs, jnp.asarray(cs.part_id))
    want_ref = jref.tile_spmm_csr_ref(*args, cs.n_dst_parts)
    want_pallas = jkernel.tile_spmm_csr_pallas(*args, jnp.asarray(flags),
                                               n_parts=cs.n_dst_parts)
    got = tops.spmm_csr(_t(cs.row_ptr, torch.int32), _t(cs.edge_src, torch.int32),
                        _t(w), _t(xs), _t(cs.part_id, torch.int32),
                        _t(flags, torch.int32), n_parts=cs.n_dst_parts).numpy()
    np.testing.assert_allclose(got, np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL)


@pytest.mark.parametrize("V,E,p,s,F", SHAPES)
def test_csr_segment_softmax_matches_reference_and_pallas(V, E, p, s, F, rng):
    g, cs = _tiles(V, E, p, s, layout="csr")
    s_g = rng.standard_normal(g.n_edges).astype(np.float32)
    v_g = rng.standard_normal((g.n_edges, F)).astype(np.float32)
    scores = _per_edge(cs, s_g, poison=1e9)
    vals = _per_edge(cs, v_g)
    flags = jkernel.tile_flags(cs.part_id)
    args = (jnp.asarray(cs.row_ptr), jnp.asarray(scores), jnp.asarray(vals),
            jnp.asarray(cs.part_id))
    want_ref = jref.segment_softmax_csr_ref(*args, cs.n_dst_parts)
    want_pallas = jkernel.segment_softmax_csr_pallas(
        *args, jnp.asarray(flags), n_parts=cs.n_dst_parts)
    got = tsoftmax.gat_aggregate_csr(
        _t(cs.row_ptr, torch.int32), _t(scores), _t(vals),
        _t(cs.part_id, torch.int32), _t(flags, torch.int32),
        n_parts=cs.n_dst_parts).numpy()
    np.testing.assert_allclose(got, np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL)


def test_csr_nan_padding_never_leaks(rng):
    """NaN in every padded edge slot (weights, scores, values): the CSR
    versions read only the row runs, so results stay finite and exact."""
    g, cs = _tiles(100, 420, 4, 3, layout="csr", seed=5)
    F = 16
    x = rng.standard_normal((g.n_vertices, F)).astype(np.float32)
    w_g = rng.standard_normal(g.n_edges).astype(np.float32)
    v_g = rng.standard_normal((g.n_edges, F)).astype(np.float32)
    xs = tops.gather_sources(cs, _t(x))
    w = _per_edge(cs, w_g, poison=np.nan)
    scores = _per_edge(cs, w_g, poison=np.nan)
    vals = _per_edge(cs, v_g, poison=np.nan)
    rp, pid = _t(cs.row_ptr, torch.int32), _t(cs.part_id, torch.int32)
    flags = _t(tkernel.tile_flags(cs.part_id), torch.int32)
    out = tops.spmm_csr(rp, _t(cs.edge_src, torch.int32), _t(w), xs, pid,
                        flags, n_parts=cs.n_dst_parts).numpy()
    whole = np.zeros((g.n_vertices, F), np.float32)
    np.add.at(whole, g.dst, w_g[:, None] * x[g.src])
    assert np.isfinite(out).all()
    _by_partition(cs, out, whole, atol=1e-4, rtol=1e-4)

    sm = tops.gat_aggregate_csr(rp, _t(scores), _t(vals), pid, flags,
                                n_parts=cs.n_dst_parts).numpy()
    assert np.isfinite(sm).all()
    _by_partition(cs, sm, _whole_graph_softmax(g, w_g, v_g), atol=1e-5,
                  rtol=1e-4)


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_multigraph_parallel_edges_keep_separate_slots(layout, rng):
    """Every parallel edge is its own softmax slot (COO per-edge columns,
    CSR per-edge runs), as in the whole-graph softmax."""
    base = jgraphs.random_graph(40, 150, seed=11)
    src = np.concatenate([base.src, base.src[:60], base.src[:20]])
    dst = np.concatenate([base.dst, base.dst[:60], base.dst[:20]])
    g = jgraphs.Graph(src=src, dst=dst, n_vertices=40)
    ts = jtiling.grid_tile(g, 3, 2, sparse=True, layout=layout)
    F = 8
    s_g = rng.standard_normal(g.n_edges).astype(np.float32)
    v_g = rng.standard_normal((g.n_edges, F)).astype(np.float32)
    pid = _t(ts.part_id, torch.int32)
    flags = _t(tkernel.tile_flags(ts.part_id), torch.int32)
    vals = _t(_per_edge(ts, v_g))
    if layout == "csr":
        got = tops.gat_aggregate_csr(_t(ts.row_ptr, torch.int32),
                                     _t(_per_edge(ts, s_g)), vals, pid, flags,
                                     n_parts=ts.n_dst_parts)
    else:
        scores = tops.densify_edge_scores(
            _t(_per_edge(ts, s_g)), _t(ts.edge_dst).long(),
            _t(ts.n_edge).long(), dmax=int(ts.part_size.max()))
        got = tops.gat_aggregate(scores, vals, pid, flags,
                                 n_parts=ts.n_dst_parts)
    _by_partition(ts, got.numpy(), _whole_graph_softmax(g, s_g, v_g),
                  atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_partition_without_tiles_gives_zero(layout, rng):
    """Destinations only in the first half of the vertex range: partitions
    past it own no tile, and every plain version writes zeros there (the
    Pallas kernels leave them unwritten; the runner masks them)."""
    V = 80
    src = rng.integers(0, V, 300).astype(np.int32)
    dst = rng.integers(0, V // 2, 300).astype(np.int32)
    ts = ttiling.grid_tile(tgraphs.Graph(src=src, dst=dst, n_vertices=V), 4, 2,
                           sparse=True, layout=layout)
    assert not set(range(2, 4)) & set(ts.part_id.tolist())
    F, P = 8, ts.n_dst_parts
    D = int(ts.part_size.max())
    pid = _t(ts.part_id, torch.int32)
    flags = _t(tkernel.tile_flags(ts.part_id), torch.int32)
    xs = _t(rng.standard_normal((ts.n_tiles, ts.s_max, F)).astype(np.float32))
    vals = _t(rng.standard_normal((ts.n_tiles, ts.e_max, F)).astype(np.float32))
    se = _t(rng.standard_normal((ts.n_tiles, ts.e_max)).astype(np.float32))
    if layout == "csr":
        rp, col = _t(ts.row_ptr, torch.int32), _t(ts.edge_src, torch.int32)
        outs = [tops.spmm_csr(rp, col, torch.ones_like(se), xs, pid, flags,
                              n_parts=P),
                tops.gat_aggregate_csr(rp, se, vals, pid, flags, n_parts=P)]
    else:
        adj, _ = tops.densify_tiles(ts)
        scores = tops.densify_edge_scores(se, _t(ts.edge_dst).long(),
                                          _t(ts.n_edge).long(), dmax=D)
        outs = [tops.spmm(_t(adj), xs, pid, flags, n_parts=P),
                tops.gat_aggregate(scores, vals, pid, flags, n_parts=P)]
    for out in outs:
        assert out.shape == (P, D, F)
        assert torch.count_nonzero(out[2:]) == 0
        assert torch.count_nonzero(out[:2]) > 0


# ---------------------------------------------------------------------------
# the CSR plan: built once per tile set, walked by the CSR SpMM kernel
# ---------------------------------------------------------------------------

def _plan_graph(case):
    """CSR tiles for a plan case: the SHAPES graphs, a power-law graph with
    a hub row of 300 in-edges (longer than a chunk), and a graph whose
    destinations leave the upper partitions without a tile."""
    if isinstance(case, tuple):
        V, E, p, s, _ = case
        return _tiles(V, E, p, s, layout="csr")
    if case == "hub":
        base = jgraphs.random_graph(200, 900, seed=7, model="powerlaw")
        hub_src = np.random.default_rng(7).integers(0, 200, 300).astype(np.int32)
        g = jgraphs.Graph(src=np.concatenate([base.src, hub_src]),
                          dst=np.concatenate([base.dst, np.full(300, 5, np.int32)]),
                          n_vertices=200)
        return g, jtiling.grid_tile(g, 3, 2, sparse=True, layout="csr")
    rng = np.random.default_rng(3)
    g = jgraphs.Graph(src=rng.integers(0, 80, 300).astype(np.int32),
                      dst=rng.integers(0, 40, 300).astype(np.int32), n_vertices=80)
    return g, jtiling.grid_tile(g, 4, 2, sparse=True, layout="csr")


PLAN_CASES = SHAPES + ["hub", "empty_partition"]
PLAN_IDS = [f"{c[0]}v{c[1]}e" for c in SHAPES] + ["hub", "empty_partition"]


def _plan(cs, chunk_size):
    return csr_plan(_t(cs.row_ptr, torch.int32), _t(cs.part_id, torch.int32),
                    cs.n_dst_parts, cs.edge_src.shape[1], chunk_size=chunk_size)


@pytest.mark.parametrize("chunk_size", [4, 128])
@pytest.mark.parametrize("case", PLAN_CASES, ids=PLAN_IDS)
def test_csr_plan_covers_every_real_slot_once(case, chunk_size):
    _, cs = _plan_graph(case)
    plan = _plan(cs, chunk_size)
    T, E = cs.edge_src.shape
    real = [t * E + e for t in range(T) for e in range(int(cs.row_ptr[t, -1]))]
    np.testing.assert_array_equal(np.sort(plan.slot.numpy()), real)
    # row r's edges are exactly the slots whose CSR run is row d of a tile of
    # partition p, r = p D + d
    D = cs.row_ptr.shape[1] - 1
    start = plan.row_start.numpy()
    for r in range(plan.n_rows):
        p, d = divmod(r, D)
        want = [t * E + e for t in np.nonzero(cs.part_id == p)[0]
                for e in range(cs.row_ptr[t, d], cs.row_ptr[t, d + 1])]
        assert plan.slot.numpy()[start[r]:start[r + 1]].tolist() == want
    np.testing.assert_array_equal(plan.zero_row.numpy(),
                                  np.nonzero(np.diff(start) == 0)[0])


@pytest.mark.parametrize("chunk_size", [4, 128])
@pytest.mark.parametrize("case", PLAN_CASES, ids=PLAN_IDS)
def test_csr_plan_chunks_stay_in_one_row(case, chunk_size):
    """Chunks (runs ending at a flagged edge) hold at most chunk_size edges
    of one row; a split row's chunks target its own partial rows in order;
    warp groups start on chunk starts."""
    _, cs = _plan_graph(case)
    plan = _plan(cs, chunk_size)
    start = plan.row_start.numpy()
    tgt = plan.edge_tgt.numpy().astype(np.int64)
    row_of = np.searchsorted(start, np.arange(tgt.size), side="right") - 1
    ends = np.nonzero(tgt < 0)[0] + 1
    assert ends.size == 0 or ends[-1] == tgt.size
    chunk_starts = np.concatenate([[0], ends[:-1]]) if ends.size else ends
    split = dict(zip(plan.split_row.tolist(),
                     zip(plan.split_ptr.tolist()[:-1], plan.split_ptr.tolist()[1:])))
    seen = {}
    for a, b in zip(chunk_starts, ends):
        assert 0 < b - a <= chunk_size
        rows = set(row_of[a:b].tolist())
        assert len(rows) == 1
        row = rows.pop()
        assert len(set((tgt[a:b] & 0x7FFFFFFF).tolist())) == 1
        t = int(tgt[b - 1] & 0x7FFFFFFF)
        assert (tgt[a:b - 1] >= 0).all() and tgt[b - 1] < 0
        if row in split:
            lo, hi = split[row]
            assert t == plan.n_rows + lo + seen.get(row, 0) and t < plan.n_rows + hi
            seen[row] = seen.get(row, 0) + 1
        else:
            assert t == row and np.diff(start)[row] <= chunk_size
    assert all(seen[r] == hi - lo for r, (lo, hi) in split.items())
    assert plan.n_partial == plan.split_ptr[-1]
    gp = plan.group_ptr.numpy()
    assert gp[0] == 0 and gp[-1] == tgt.size
    assert set(gp[:-1].tolist()) <= set(chunk_starts.tolist())
    assert LAST == -2 ** 31


@pytest.mark.parametrize("chunk_size", [4, 128])
@pytest.mark.parametrize("case", PLAN_CASES, ids=PLAN_IDS)
def test_csr_plan_walk_matches_reference_and_pallas(case, chunk_size, rng):
    """The plain walk of the plan (what the CUDA kernel computes) against
    the port's and repro's plain versions and the Pallas kernel, with NaN
    in every padded slot."""
    g, cs = _plan_graph(case)
    F = 8
    x = rng.standard_normal((g.n_vertices, F)).astype(np.float32)
    w_g = rng.standard_normal(g.n_edges).astype(np.float32)
    xs = np.asarray(jops.gather_sources(cs, x))
    w = _per_edge(cs, w_g, poison=np.nan)
    args = (_t(cs.row_ptr, torch.int32), _t(cs.edge_src, torch.int32), _t(w),
            _t(xs), _t(cs.part_id, torch.int32))
    flags = jkernel.tile_flags(cs.part_id)
    got = tops.spmm_csr(*args, _t(flags, torch.int32), n_parts=cs.n_dst_parts,
                        plan=_plan(cs, chunk_size)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, tref.tile_spmm_csr_ref(*args, cs.n_dst_parts).numpy(), **TOL)
    w0 = _per_edge(cs, w_g, poison=0.0)    # the JAX versions multiply padding
    jargs = (jnp.asarray(cs.row_ptr), jnp.asarray(cs.edge_src), jnp.asarray(w0),
             xs, jnp.asarray(cs.part_id))
    # the Pallas kernel leaves partitions without a tile unwritten (the
    # runner masks them); the plan writes zeros there
    live = np.isin(np.arange(cs.n_dst_parts), cs.part_id)
    assert not got[~live].any()
    np.testing.assert_allclose(
        got[live], np.asarray(jref.tile_spmm_csr_ref(*jargs, cs.n_dst_parts))[live],
        **TOL)
    np.testing.assert_allclose(
        got[live], np.asarray(jkernel.tile_spmm_csr_pallas(
            *jargs, jnp.asarray(flags), n_parts=cs.n_dst_parts))[live], **TOL)


def test_coo_off_path_reaches_every_tail():
    """chip_smoke.py's off-path COO SpMM cases reach F not a multiple of 4
    (x read a column a lane), F over 128 (two column slices), F under 128
    (idle lanes), S not a multiple of 4 (the adjacency read a float a lane)
    and a partition with no tile."""
    cases = _chip_smoke().COO_OFF_PATH
    assert any(c["F"] % 4 for c in cases)
    assert any(c["F"] > 128 for c in cases)
    assert any(c["F"] < 128 and c["F"] % 4 == 0 for c in cases)
    assert any(c["S"] % 4 for c in cases)
    assert any(0 in c["parts"] for c in cases)
    for c in cases:                                  # plain version: zeros there
        rng = np.random.default_rng(0)
        T, P = sum(c["parts"]), len(c["parts"])
        pid = _t(np.repeat(np.arange(P, dtype=np.int32), c["parts"]))
        adj = _t(rng.standard_normal((T, c["D"], c["S"])).astype(np.float32))
        x = _t(rng.standard_normal((T, c["S"], c["F"])).astype(np.float32))
        out = tops.spmm(adj, x, pid, _t(tkernel.tile_flags(pid.numpy())), n_parts=P)
        assert out.shape == (P, c["D"], c["F"])
        for p, n in enumerate(c["parts"]):
            assert (torch.count_nonzero(out[p]) == 0) == (n == 0)


def test_partition_ptr_matches_the_device_runs():
    pid = np.array([0, 0, 1, 3, 3, 3], np.int32)
    ptr = tkernel.partition_ptr(pid, 5)
    np.testing.assert_array_equal(ptr, [0, 2, 3, 3, 6, 6])
    np.testing.assert_array_equal(
        tkernel._part_ptr(_t(pid, torch.int32), 5, None).numpy(), ptr)
    given = _t(ptr, torch.int32)
    assert tkernel._part_ptr(_t(pid, torch.int32), 5, given) is given
    with pytest.raises(ValueError, match="shape"):
        tkernel._part_ptr(_t(pid, torch.int32), 4, given)


# ---------------------------------------------------------------------------
# wrappers: metadata helpers and the no-fallback rule
# ---------------------------------------------------------------------------

def test_tile_flags_and_partition_order():
    pid = np.array([0, 0, 1, 3, 3, 3], np.int32)
    np.testing.assert_array_equal(tkernel.tile_flags(pid),
                                  jkernel.tile_flags(pid))
    tkernel.check_partition_major(pid)
    with pytest.raises(ValueError, match="partition-major"):
        tkernel.check_partition_major(np.array([0, 2, 1], np.int32))


@pytest.mark.parametrize("wrapper,n_args", [
    (tkernel.tile_spmm_cuda, 4), (tkernel.tile_spmm_csr_cuda, 6),
    (tkernel.segment_softmax_cuda, 4), (tkernel.segment_softmax_csr_cuda, 5)])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper, n_args):
    """No silent fallback: a CUDA wrapper given host tensors raises."""
    args = [torch.zeros((2, 3, 4))] + [torch.zeros(2, dtype=torch.int32)] * (n_args - 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(*args, n_parts=2)
