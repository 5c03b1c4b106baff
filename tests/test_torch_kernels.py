"""The port's plain tile-kernel versions against `repro`'s refs and its
Pallas kernels (interpret mode), on the `test_kernels.py` shapes.

The port's segment softmaxes take per-edge operands (scores, the tiles'
column indices, the source operand); `repro`'s take a dense score block
(COO) and gathered (T, E, F) values, built here from the same numpy inputs.
The plan-walking versions take the source operand in two forms, the
tiles' replica with tile-local columns or the flat store with global ones;
the plan-walk tests run both and hold them to the same bits.

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
from repro_torch.kernels.tile_spmm.plan import (CHUNK_SIZE, LAST, coo_plan,
                                                csr_plan, edge_plan)

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


def _gathered(ts, xs):
    """repro's (T, E, F) per-edge values: the source replica's row of every
    edge slot, xs[t, edge_src[t, e]]."""
    return np.take_along_axis(np.asarray(xs), ts.edge_src[..., None].astype(np.int64),
                              axis=1)


def _softmax_operands(ts):
    """The port's layout operands of tiles ``ts`` (int32 tensors): (edge_dst,
    n_edge) for COO, (row_ptr,) for CSR; then col, part_id, flags."""
    lay = ((_t(ts.row_ptr, torch.int32),) if ts.layout == "csr" else
           (_t(ts.edge_dst, torch.int32), _t(ts.n_edge, torch.int32)))
    return (lay, _t(ts.edge_src, torch.int32), _t(ts.part_id, torch.int32),
            _t(tkernel.tile_flags(ts.part_id), torch.int32))


FORMS = ["replica", "flat"]


def _flat_source(ts, x):
    """The flat-store form of the source operand over features ``x``
    (V, F): the store, with NaN in every row no real edge names and in two
    rows past V, and the (T, E) int32 global columns ``src_ids[t,
    edge_src[t, e]]``, each padded slot naming a NaN row."""
    V, F = x.shape
    gcol = np.take_along_axis(ts.src_ids, ts.edge_src, axis=1)
    real = np.arange(ts.edge_src.shape[1])[None, :] < ts.n_edge[:, None]
    named = np.unique(gcol[real])
    store = np.full((V + 2, F), np.nan, np.float32)
    store[named] = x[named]
    assert np.isnan(store).any(axis=1).sum() >= 2
    return _t(store), _t(np.where(real, gcol, V + 1), torch.int32)


def _softmax_plan(ts, chunk_size=CHUNK_SIZE):
    lay, _, pid, _ = _softmax_operands(ts)
    if ts.layout == "csr":
        return csr_plan(*lay, pid, ts.n_dst_parts, ts.e_max, chunk_size=chunk_size)
    return coo_plan(*lay, pid, ts.n_dst_parts, int(ts.part_size.max()),
                    chunk_size=chunk_size)


def _port_softmax(ts, scores, xs, plan=None, col=None):
    """The port's softmax entry point for ``ts``'s layout (CPU: the plan
    walk when ``plan`` is given, else the edge list); ``col`` replaces the
    tile-local columns (global ones, for the flat store ``xs``)."""
    lay, local, pid, flags = _softmax_operands(ts)
    col = local if col is None else col
    if ts.layout == "csr":
        return tsoftmax.gat_aggregate_csr(*lay, col, _t(scores), _t(xs), pid, flags,
                                          n_parts=ts.n_dst_parts, plan=plan).numpy()
    return tsoftmax.gat_aggregate(*lay, col, _t(scores), _t(xs), pid, flags,
                                  n_parts=ts.n_dst_parts,
                                  dmax=int(ts.part_size.max()), plan=plan).numpy()


def _repro_softmax(ts, scores, xs):
    """repro's plain version and Pallas kernel (interpret mode) on its own
    operands: the densified score block (COO) or the row pointers (CSR),
    and the gathered values."""
    vals = jnp.asarray(_gathered(ts, xs))
    pid, P = jnp.asarray(ts.part_id), ts.n_dst_parts
    flags = jnp.asarray(jkernel.tile_flags(ts.part_id))
    if ts.layout == "csr":
        args = (jnp.asarray(ts.row_ptr), jnp.asarray(scores), vals, pid)
        return (jref.segment_softmax_csr_ref(*args, P),
                jkernel.segment_softmax_csr_pallas(*args, flags, n_parts=P))
    dense = jops.densify_edge_scores(jnp.asarray(scores), jnp.asarray(ts.edge_dst),
                                     jnp.asarray(ts.n_edge),
                                     dmax=int(ts.part_size.max()))
    return (jref.segment_softmax_ref(dense, vals, pid, P),
            jkernel.segment_softmax_pallas(dense, vals, pid, flags, n_parts=P))


@pytest.mark.parametrize("V,E,p,s,F", SHAPES + [(90, 400, 3, 3, 12)])
def test_segment_softmax_matches_reference_and_pallas(V, E, p, s, F, rng):
    """COO: the dense score block is built alike in both packages, the
    port's dense plain version matches repro's, and the port's per-edge
    versions (edge list and coo_plan walk) match repro's ref and Pallas
    kernel on their own operands, and the whole-graph softmax."""
    g, ts = _tiles(V, E, p, s)
    D = int(ts.part_size.max())
    s_g = rng.standard_normal(g.n_edges).astype(np.float32)
    x = rng.standard_normal((V, F)).astype(np.float32)
    scores_e = _per_edge(ts, s_g)
    xs = np.asarray(jops.gather_sources(ts, x))
    jscores = jops.densify_edge_scores(jnp.asarray(scores_e),
                                       jnp.asarray(ts.edge_dst),
                                       jnp.asarray(ts.n_edge), dmax=D)
    tscores = tsoftmax.densify_edge_scores(
        _t(scores_e), _t(ts.edge_dst).long(), _t(ts.n_edge).long(), dmax=D)
    np.testing.assert_array_equal(tscores.numpy(), np.asarray(jscores))

    want_ref, want_pallas = _repro_softmax(ts, scores_e, xs)
    dense = tsoftmax.segment_softmax_ref(tscores, _t(_gathered(ts, xs)),
                                         _t(ts.part_id, torch.int32),
                                         ts.n_dst_parts).numpy()
    np.testing.assert_allclose(dense, np.asarray(want_ref), **TOL)
    for plan in (None, _softmax_plan(ts)):
        got = _port_softmax(ts, scores_e, xs, plan)
        np.testing.assert_allclose(got, np.asarray(want_ref), **TOL)
        np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL)
        _by_partition(ts, got, _whole_graph_softmax(g, s_g, x[g.src]),
                      atol=1e-5, rtol=1e-4)


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
    x = rng.standard_normal((V, F)).astype(np.float32)
    scores = _per_edge(cs, s_g, poison=1e9)
    xs = np.asarray(jops.gather_sources(cs, x))
    want_ref, want_pallas = _repro_softmax(cs, scores, xs)
    for plan in (None, _softmax_plan(cs)):
        got = _port_softmax(cs, scores, xs, plan)
        np.testing.assert_allclose(got, np.asarray(want_ref), **TOL)
        np.testing.assert_allclose(got, np.asarray(want_pallas), **TOL)


def test_csr_nan_padding_never_leaks(rng):
    """NaN in every padded edge slot (weights, scores): the CSR versions
    read only the row runs or the plan, so results stay finite and exact."""
    g, cs = _tiles(100, 420, 4, 3, layout="csr", seed=5)
    F = 16
    x = rng.standard_normal((g.n_vertices, F)).astype(np.float32)
    w_g = rng.standard_normal(g.n_edges).astype(np.float32)
    xs = tops.gather_sources(cs, _t(x))
    w = _per_edge(cs, w_g, poison=np.nan)
    scores = _per_edge(cs, w_g, poison=np.nan)
    rp, pid = _t(cs.row_ptr, torch.int32), _t(cs.part_id, torch.int32)
    flags = _t(tkernel.tile_flags(cs.part_id), torch.int32)
    out = tops.spmm_csr(rp, _t(cs.edge_src, torch.int32), _t(w), xs, pid,
                        flags, n_parts=cs.n_dst_parts).numpy()
    whole = np.zeros((g.n_vertices, F), np.float32)
    np.add.at(whole, g.dst, w_g[:, None] * x[g.src])
    assert np.isfinite(out).all()
    _by_partition(cs, out, whole, atol=1e-4, rtol=1e-4)

    for plan in (None, _softmax_plan(cs)):
        sm = _port_softmax(cs, scores, xs, plan)
        assert np.isfinite(sm).all()
        _by_partition(cs, sm, _whole_graph_softmax(g, w_g, x[g.src]), atol=1e-5,
                      rtol=1e-4)


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_multigraph_parallel_edges_keep_separate_slots(layout, rng):
    """Every parallel edge is its own softmax slot (its own plan edge and
    edge-list entry), as in the whole-graph softmax."""
    base = jgraphs.random_graph(40, 150, seed=11)
    src = np.concatenate([base.src, base.src[:60], base.src[:20]])
    dst = np.concatenate([base.dst, base.dst[:60], base.dst[:20]])
    g = jgraphs.Graph(src=src, dst=dst, n_vertices=40)
    ts = jtiling.grid_tile(g, 3, 2, sparse=True, layout=layout)
    F = 8
    s_g = rng.standard_normal(g.n_edges).astype(np.float32)
    x = rng.standard_normal((g.n_vertices, F)).astype(np.float32)
    xs = np.asarray(jops.gather_sources(ts, x))
    for plan in (None, _softmax_plan(ts)):
        got = _port_softmax(ts, _per_edge(ts, s_g), xs, plan)
        _by_partition(ts, got, _whole_graph_softmax(g, s_g, x[g.src]),
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
    se = rng.standard_normal((ts.n_tiles, ts.e_max)).astype(np.float32)
    if layout == "csr":
        rp, col = _t(ts.row_ptr, torch.int32), _t(ts.edge_src, torch.int32)
        outs = [tops.spmm_csr(rp, col, torch.ones_like(_t(se)), xs, pid, flags,
                              n_parts=P)]
    else:
        adj, _ = tops.densify_tiles(ts)
        outs = [tops.spmm(_t(adj), xs, pid, flags, n_parts=P)]
    outs += [torch.as_tensor(_port_softmax(ts, se, xs, plan))
             for plan in (None, _softmax_plan(ts))]
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


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("chunk_size", [4, 128])
@pytest.mark.parametrize("case", PLAN_CASES, ids=PLAN_IDS)
def test_csr_plan_walk_matches_reference_and_pallas(case, chunk_size, form, rng):
    """The plain walk of the plan (what the CUDA kernel computes) against
    the port's and repro's plain versions and the Pallas kernel, with NaN
    in every padded slot.  In the flat form (the store, NaN in every row
    no edge names, and global columns) both plain versions give the
    replica's bits."""
    g, cs = _plan_graph(case)
    F = 8
    x = rng.standard_normal((g.n_vertices, F)).astype(np.float32)
    w_g = rng.standard_normal(g.n_edges).astype(np.float32)
    xs = np.asarray(jops.gather_sources(cs, x))
    w = _per_edge(cs, w_g, poison=np.nan)
    rp, pid = _t(cs.row_ptr, torch.int32), _t(cs.part_id, torch.int32)
    args = (rp, _t(cs.edge_src, torch.int32), _t(w), _t(xs), pid)
    flags = jkernel.tile_flags(cs.part_id)
    plan = _plan(cs, chunk_size)
    walk = tops.spmm_csr(*args, _t(flags, torch.int32), n_parts=cs.n_dst_parts,
                         plan=plan)
    edges = tref.tile_spmm_csr_ref(*args, cs.n_dst_parts)
    if form == "flat":
        store, gcol = _flat_source(cs, x)
        fargs = (rp, gcol, _t(w), store, pid)
        flat_walk = tops.spmm_csr(*fargs, _t(flags, torch.int32),
                                  n_parts=cs.n_dst_parts, plan=plan)
        assert torch.equal(flat_walk, walk)
        assert torch.equal(tref.tile_spmm_csr_ref(*fargs, cs.n_dst_parts), edges)
    got = walk.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, edges.numpy(), **TOL)
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


# ---------------------------------------------------------------------------
# the edge plan of either layout, walked by both segment softmaxes
# ---------------------------------------------------------------------------

HUB3 = 3 * CHUNK_SIZE + 20        # parallel in-edges of the hub row: 4 chunks


def _softmax_graph(case, layout):
    """Tiles for a softmax case: ``hub3`` (a row of HUB3 parallel in-edges
    from 40 sources, over 3 chunks), ``empty_partition`` (destinations in
    the lower half: partitions without a tile), ``dead_score`` (the SHAPES
    graph whose COO scores fall below -1e29 on some edges)."""
    if case == "hub3":
        base = jgraphs.random_graph(200, 900, seed=7, model="powerlaw")
        hub_src = (np.arange(HUB3) % 40).astype(np.int32)
        g = jgraphs.Graph(src=np.concatenate([base.src, hub_src]),
                          dst=np.concatenate([base.dst, np.full(HUB3, 5, np.int32)]),
                          n_vertices=200)
        return g, jtiling.grid_tile(g, 3, 2, sparse=True, layout=layout)
    if case == "empty_partition":
        rng = np.random.default_rng(3)
        g = jgraphs.Graph(src=rng.integers(0, 80, 300).astype(np.int32),
                          dst=rng.integers(0, 40, 300).astype(np.int32),
                          n_vertices=80)
        return g, jtiling.grid_tile(g, 4, 2, sparse=True, layout=layout)
    return _tiles(120, 500, 4, 4, layout=layout)


def _softmax_scores(g, ts, rng, dead=None):
    """(global scores, per-slot scores with NaN padding); ``dead`` scores
    every edge into vertex 3 and ~10 % of the rest with that value."""
    s_g = rng.standard_normal(g.n_edges).astype(np.float32)
    if dead is not None:
        s_g[(g.dst == 3) | (rng.random(g.n_edges) < 0.1)] = dead
    return s_g, _per_edge(ts, s_g, poison=np.nan)


SOFTMAX_CASES = [("hub3", "coo"), ("hub3", "csr"), ("empty_partition", "coo"),
                 ("empty_partition", "csr"), ("dead_score", "coo")]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case,layout", SOFTMAX_CASES,
                         ids=[f"{c}-{l}" for c, l in SOFTMAX_CASES])
def test_segment_softmax_walks_match_reference_and_pallas(case, layout, form,
                                                          rng):
    """Both plain versions of the port (the plan walk, the edge list) on
    per-edge operands against repro's ref and Pallas kernel on theirs: a
    hub row over 3 chunks of parallel edges, partitions without a tile
    (Pallas leaves them unwritten, the port writes zeros), COO edges scored
    below the liveness cut of both repro versions (a row of only those is
    0).  In the flat form (the store, NaN in every row no edge names, and
    global columns) both give the replica's bits."""
    g, ts = _softmax_graph(case, layout)
    F = 8
    x = rng.standard_normal((g.n_vertices, F)).astype(np.float32)
    xs = np.asarray(jops.gather_sources(ts, x))
    s_g, scores = _softmax_scores(g, ts, rng, -7e29 if case == "dead_score" else None)
    want_ref, want_pallas = _repro_softmax(ts, np.nan_to_num(scores, nan=0.0), xs)
    live = np.isin(np.arange(ts.n_dst_parts), ts.part_id)
    plan = _softmax_plan(ts)
    if case == "hub3":
        assert int(plan.split_ptr.diff().max()) >= 3
    for p_ in (None, plan):
        got = _port_softmax(ts, scores, xs, p_)
        if form == "flat":
            store, gcol = _flat_source(ts, x)
            flat = _port_softmax(ts, scores, store, p_, col=gcol)
            assert torch.equal(torch.from_numpy(flat), torch.from_numpy(got))
        assert np.isfinite(got).all() and not got[~live].any()
        np.testing.assert_allclose(got[live], np.asarray(want_ref)[live], **TOL)
        np.testing.assert_allclose(got[live], np.asarray(want_pallas)[live], **TOL)
    if case == "dead_score":                 # every edge into vertex 3 is dead
        assert (g.dst == 3).any()
        p = np.searchsorted(ts.part_start, 3, "right") - 1
        assert not got[p, 3 - ts.part_start[p]].any()


PLAIN_CASES = [(c, l) for c in PLAN_CASES + ["hub3"] for l in ("coo", "csr")]
PLAIN_IDS = [f"{i}-{l}" for i in PLAN_IDS + ["hub3"] for l in ("coo", "csr")]


@pytest.mark.parametrize("chunk_size", [4, 128])
@pytest.mark.parametrize("case,layout", PLAIN_CASES, ids=PLAIN_IDS)
def test_segment_softmax_plain_versions_agree(case, layout, chunk_size, rng):
    """The plan walk (partial (m, l, acc) a chunk, then the merge of a split
    row's partials: what the CUDA kernel computes) and the edge list give
    the same output, with NaN in every padded slot and, in COO, edges
    scored -2e29 (below the cut)."""
    if case == "hub3":
        g, ts = _softmax_graph(case, layout)
    elif isinstance(case, tuple):
        V, E, p, s, _ = case
        g, ts = _tiles(V, E, p, s, layout=layout)
    else:
        g, cs = _plan_graph(case)
        ts = jtiling.grid_tile(g, *((3, 2) if case == "hub" else (4, 2)),
                               sparse=True, layout=layout)
    F = 12
    xs = rng.standard_normal((ts.n_tiles, ts.s_max, F)).astype(np.float32)
    _, scores = _softmax_scores(g, ts, rng, -2e29 if layout == "coo" else None)
    walk = _port_softmax(ts, scores, xs, _softmax_plan(ts, chunk_size))
    edges = _port_softmax(ts, scores, xs)
    assert np.isfinite(walk).all()
    np.testing.assert_allclose(walk, edges, **TOL)


@pytest.mark.parametrize("case", PLAN_CASES + ["hub3"], ids=PLAN_IDS + ["hub3"])
def test_coo_and_csr_plans_give_every_row_the_same_edges(case):
    """One graph tiled both ways: coo_plan and csr_plan give every output
    row the same multiset of edges (by global edge id)."""
    if case == "hub3":
        g, _ = _softmax_graph(case, "coo")
        grid = (3, 2)
    elif isinstance(case, tuple):
        V, E, p, s, _ = case
        g, grid = jgraphs.random_graph(V, E, seed=V), (p, s)
    else:
        g, _ = _plan_graph(case)
        grid = (3, 2) if case == "hub" else (4, 2)
    rows = []
    for layout in ("coo", "csr"):
        ts = jtiling.grid_tile(g, *grid, sparse=True, layout=layout)
        plan = _softmax_plan(ts)
        gid = ts.edge_gid.reshape(-1)[plan.slot.numpy()]
        start = plan.row_start.numpy()
        rows.append([sorted(gid[start[r]:start[r + 1]].tolist())
                     for r in range(plan.n_rows)])
    assert rows[0] == rows[1]
    assert sum(map(len, rows[0])) == g.n_edges


def _plan_by_hand(rows, n_rows, chunk_size):
    """The plan's definition, row by row: ``rows[r]`` lists row r's edge
    slots in (tile, slot) order."""
    slot, tgt, row_start, zero, split_row, split_ptr = [], [], [0], [], [], [0]
    chunk_starts = []
    for r in range(n_rows):
        es = rows[r]
        n_chunks = -(-len(es) // chunk_size)
        if not es:
            zero.append(r)
        base = None
        if n_chunks > 1:
            split_row.append(r)
            base = n_rows + split_ptr[-1]
            split_ptr.append(split_ptr[-1] + n_chunks)
        for i, e in enumerate(es):
            if i % chunk_size == 0:
                chunk_starts.append(len(slot))
            t = r if base is None else base + i // chunk_size
            last = i == len(es) - 1 or i % chunk_size == chunk_size - 1
            tgt.append(t + LAST if last else t)
            slot.append(e)
        row_start.append(len(slot))
    group = [c for k, c in enumerate(chunk_starts)
             if k == 0 or c // 32 != chunk_starts[k - 1] // 32]
    return dict(slot=slot, edge_tgt=tgt, row_start=row_start, zero_row=zero,
                split_row=split_row, split_ptr=split_ptr,
                group_ptr=group + [len(slot)], n_partial=split_ptr[-1])


@pytest.mark.parametrize("chunk_size", [4, 128])
@pytest.mark.parametrize("case", PLAN_CASES + ["hub3"], ids=PLAN_IDS + ["hub3"])
def test_plans_match_their_definition(case, chunk_size):
    """csr_plan, now _csr_edges + edge_plan, and coo_plan build exactly the
    plan the kernel walks, written out row by row: slots grouped by row in
    tile order, chunk targets with the last-edge bit, warp groups, zero and
    split rows."""
    if case == "hub3":
        g, _ = _softmax_graph(case, "coo")
        grid = (3, 2)
    elif isinstance(case, tuple):
        V, E, p, s, _ = case
        g, grid = jgraphs.random_graph(V, E, seed=V), (p, s)
    else:
        g, _ = _plan_graph(case)
        grid = (3, 2) if case == "hub" else (4, 2)
    for layout in ("coo", "csr"):
        ts = jtiling.grid_tile(g, *grid, sparse=True, layout=layout)
        T, E = ts.edge_src.shape
        D = int(ts.part_size.max())
        rows = [[] for _ in range(ts.n_dst_parts * D)]
        for t in range(T):
            for e in range(int(ts.n_edge[t])):
                d = (np.searchsorted(ts.row_ptr[t], e, "right") - 1
                     if layout == "csr" else ts.edge_dst[t, e])
                rows[int(ts.part_id[t]) * D + int(d)].append(t * E + e)
        want = _plan_by_hand(rows, ts.n_dst_parts * D, chunk_size)
        plan = _softmax_plan(ts, chunk_size)
        assert plan.n_rows == ts.n_dst_parts * D and plan.chunk_size == chunk_size
        assert plan.n_partial == want.pop("n_partial")
        for name, value in want.items():
            got = getattr(plan, name)
            assert got.dtype == torch.int32, name
            np.testing.assert_array_equal(got.numpy(), np.asarray(value, np.int64),
                                          err_msg=name)
        if layout == "csr":             # the layout-free builder, called directly
            t_, e_, dest = tref._csr_edges(_t(ts.row_ptr, torch.int32),
                                           _t(ts.part_id, torch.int32), E)
            direct = edge_plan(t_, e_, dest, ts.n_dst_parts * D, E, chunk_size)
            np.testing.assert_array_equal(direct.edge_tgt.numpy(),
                                          plan.edge_tgt.numpy())


def test_softmax_off_path_reaches_every_tail():
    """chip_smoke.py's off-path softmax cases reach F not a multiple of 4
    (a column a lane, in slices), F under 128 (idle lanes), a row split into
    3 or more chunks and partitions without a tile in both layouts, and in
    COO edges below the liveness cut, a row of only those giving 0."""
    cs_mod = _chip_smoke()
    Fs = [c["F"] for c in cs_mod.SOFTMAX_OFF_PATH]
    assert any(F % 4 for F in Fs) and any(F > 128 for F in Fs)
    assert any(F < 128 and F % 4 == 0 for F in Fs)
    c = cs_mod.SOFTMAX_GRAPH
    rng = np.random.default_rng(0)
    for layout in ("coo", "csr"):
        g, ts = cs_mod.softmax_off_path_tiles(layout)
        plan = _softmax_plan(ts)
        assert int(plan.split_ptr.diff().max()) >= 3
        assert not np.isin(np.arange(ts.n_dst_parts), ts.part_id).all()
        if layout == "coo":
            assert (g.dst == c["dead_row"]).any()
            s_g = rng.standard_normal(g.n_edges).astype(np.float32)
            s_g[g.dst == c["dead_row"]] = cs_mod.DEAD_SCORE
            xs = rng.standard_normal((ts.n_tiles, ts.s_max, 4)).astype(np.float32)
            out = _port_softmax(ts, _per_edge(ts, s_g, poison=np.nan), xs, plan)
            p = np.searchsorted(ts.part_start, c["dead_row"], "right") - 1
            assert not out[p, c["dead_row"] - ts.part_start[p]].any()
            assert out[p].any()


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


@pytest.mark.parametrize("wrapper,n_args,kwargs", [
    (tkernel.tile_spmm_cuda, 4, {}), (tkernel.tile_spmm_csr_cuda, 6, {}),
    (tkernel.segment_softmax_cuda, 7, {"dmax": 3}),
    (tkernel.segment_softmax_csr_cuda, 6, {})],
    ids=["tile_spmm_cuda-4", "tile_spmm_csr_cuda-6", "segment_softmax_cuda-4",
         "segment_softmax_csr_cuda-5"])          # the ids the cases have always had
def test_cuda_wrappers_refuse_cpu_tensors(wrapper, n_args, kwargs):
    """No silent fallback: a CUDA wrapper given host tensors raises."""
    args = [torch.zeros((2, 3, 4))] + [torch.zeros(2, dtype=torch.int32)] * (n_args - 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(*args, n_parts=2, **kwargs)
