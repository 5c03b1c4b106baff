"""Time the grouped FFN and the COO tile SpMM of two trees in turns, on one card.

    python3 tools/kernel_ab.py [--tree DIR] [--rounds N]

Loads the ``repro_torch`` kernels of this checkout and, with ``--tree``,
of an unpacked older tree (its ``src/``), each building its own sources,
and times each kernel at ``chip_smoke.py``'s main-path shapes in turns
(older, this, this, older, ... for ``--rounds`` rounds; median of 20
CUDA-event-timed calls each, through each tree's Python wrapper): the COO
tile SpMM at the serving batch's tiles (phase 3) and the grouped FFN at a
1,024-token prefill chunk and a 4-token decode step of DeepSeek-V2's MoE
layer, fp32 and bf16 (phase 6).  Then times this tree's grouped FFN at
other launch configurations (``launch_config``'s ``ksplit`` and ``slots``),
calling the C entry point directly.  Every result is checked against the
plain version (max abs difference printed).  Prints one JSON line per
measurement and the card's name and power limit.  Needs a CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def load_tree(tree: Path) -> dict:
    """The kernel wrappers of ``tree``'s ``repro_torch``, imported afresh
    (the modules of an earlier tree are dropped from ``sys.modules``; the
    functions keep their own globals)."""
    for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(tree.resolve() / "src"))
    try:
        mods = {k: importlib.import_module(f"repro_torch.kernels.{k}")
                for k in ("tile_spmm.kernel", "moe_dispatch.kernel")}
    finally:
        sys.path.pop(0)
    mods["tile_spmm.kernel"].library()
    mods["moe_dispatch.kernel"].library()
    return mods


def operands(dev):
    """The main-path operands of both kernels, as ``chip_smoke.py`` phases 3
    and 6 build them: ``coo`` = (adj, xsrc, part_id, flags, part_ptr, P,
    plain result); ``ffn`` = {(case, dtype): ((buckets, wg, wu, wd, counts),
    plain result)} for the prefill chunk and the decode step."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.gnn import graphs as G
    from repro_torch.kernels.moe_dispatch import ops as moe_ops
    from repro_torch.kernels.moe_dispatch.ref import grouped_ffn_ref
    from repro_torch.kernels.tile_spmm import ops
    from repro_torch.kernels.tile_spmm.kernel import partition_ptr
    from repro_torch.kernels.tile_spmm.ref import tile_spmm_ref
    from repro_torch.models.moe import capacity
    from repro_torch.serve import ShapeRegistry
    sys.path.pop(0)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    graphs = [G.random_graph(2000, 16000, seed=i, model="powerlaw") for i in range(16)]
    _, ts, _, _ = ShapeRegistry().canonical("shapes", G.batch_graphs(graphs).graph)
    T, S, E, P, D = ts.n_tiles, ts.s_max, ts.e_max, ts.n_dst_parts, int(ts.part_size.max())
    part_id = torch.as_tensor(ts.part_id, dtype=torch.int32, device=dev)
    flags = torch.zeros(T, dtype=torch.int32, device=dev)
    part_ptr = torch.as_tensor(partition_ptr(ts.part_id, P), device=dev)
    adj = ops.densify_edge_weights(
        randn(T, E), torch.as_tensor(ts.edge_dst, device=dev).long(),
        torch.as_tensor(ts.edge_src, device=dev).long(),
        torch.as_tensor(ts.n_edge, device=dev).long(), dmax=D, smax=S)
    xsrc = randn(T, S, 128)
    coo = (adj, xsrc, part_id, flags, part_ptr, P, tile_spmm_ref(adj, xsrc, part_id, P))
    cfg = get_config("deepseek-v2-236b")
    mo = cfg.moe
    En, d, f = mo.n_routed, cfg.d_model, mo.d_ff_expert
    w32 = [randn(En, d, f, scale=d ** -0.5), randn(En, d, f, scale=d ** -0.5),
           randn(En, f, d, scale=f ** -0.5)]
    router = randn(d, En, scale=d ** -0.5)
    ffn = {}
    for case, n_tok in (("prefill_chunk", 1024), ("decode", 4)):
        cap = capacity(cfg, n_tok)
        x = randn(n_tok, d)
        r = moe_ops.route(x, router, mo.top_k, cap, norm_topk=mo.norm_topk)
        counts = torch.clamp(r.counts, max=cap).to(torch.int32)
        for dt in (torch.float32, torch.bfloat16):
            a = (moe_ops.dispatch(x, r, En, cap).to(dt), *(w.to(dt) for w in w32), counts)
            ffn[(case, str(dt).split(".")[1])] = (a, grouped_ffn_ref(*a).float())
    return coo, ffn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import dataclasses

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    (adj, xsrc, part_id, flags, part_ptr, P, coo_want), ffn_cases = operands(dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    trees = {"this": load_tree(ROOT)}
    if args.tree is not None:
        trees = {"older": load_tree(args.tree), **trees}
    order = list(trees) + list(trees)[::-1]

    def emit(**kw):
        print(json.dumps(dict(nvidia_smi=smi, **kw)), flush=True)

    for rnd in range(args.rounds):
        for tree in order:
            m = trees[tree]
            K, GK = m["tile_spmm.kernel"], m["moe_dispatch.kernel"]

            def coo():
                return K.tile_spmm_cuda(adj, xsrc, part_id, flags, n_parts=P,
                                        part_ptr=part_ptr)
            emit(kernel="tile_spmm", case="serving", tree=tree, round=rnd,
                 ms=time_ms(coo), max_abs_err=float((coo() - coo_want).abs().max()))
            for (case, dt), (a, want) in ffn_cases.items():
                emit(kernel="grouped_ffn", case=case, dtype=dt, tree=tree, round=rnd,
                     ms=time_ms(lambda: GK.grouped_ffn_cuda(*a), runs=10),
                     max_abs_err=float((GK.grouped_ffn_cuda(*a).float() - want).abs().max()))

    # this tree's grouped FFN at other launch configurations
    GK = trees["this"]["moe_dispatch.kernel"]
    lib = GK.library()
    for (case, dt), (a, want) in ffn_cases.items():
        buckets, wg, wu, wd, counts = a
        Ec, C, dd = buckets.shape
        ff = wg.shape[-1]
        tdt = buckets.dtype
        out = torch.empty_like(buckets)
        act = torch.empty((Ec, C, ff), dtype=torch.float32, device=dev)
        for ksplit in (1, 2, 4):
            for slots in (2, 3, 4):
                c = GK.launch_config(Ec, C, dd, ff, tdt, ksplit=ksplit, slots=slots)
                if c.slices * c.ksplit > 12 or c.smem > GK.MAX_SMEM:
                    continue

                def run(c=c):
                    err = lib.zipper_grouped_ffn(
                        buckets.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                        counts.data_ptr(), act.data_ptr(), out.data_ptr(), Ec, C, dd, ff,
                        int(tdt == torch.bfloat16), c.slices, c.ksplit, c.slots, c.smem,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"zipper_grouped_ffn: CUDA error {err}")
                    return out
                emit(kernel="grouped_ffn", case=case, dtype=dt, tree="this",
                     config=dataclasses.asdict(c), chosen=(c == GK.launch_config(Ec, C, dd, ff, tdt)),
                     ms=time_ms(run, runs=10),
                     max_abs_err=float((run().float() - want).abs().max()))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
