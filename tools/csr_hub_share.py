"""How much of the CSR tile SpMM's time its longest rows take, on one card.

    python3 tools/csr_hub_share.py [--tree DIR]

Times the CSR tile SpMM kernel of the ``repro_torch`` package under
``DIR/src`` (default: this checkout; give an unpacked older tree to time
its kernel) on the coAuthorsDBLP stand-in's CSR tiles, as ``chip_smoke.py``
phases 3 and 5 build them, three ways: with all edges; without the
in-edges of the largest hub; without the in-edges of every vertex that has
more than 128 (the rows the CSR plan cuts into chunks).  Prints one JSON
line per case with the edges left, the kernel's median time over 20
CUDA-event-timed calls, and the share of the full time that the removed
edges took.  A kernel that takes a CSR plan gets it built outside the
timing.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import inspect
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("csr_hub_share: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    from repro_torch.core.tiling import grid_tile
    from repro_torch.gnn import graphs as G
    from repro_torch.kernels.tile_spmm import kernel as K

    takes_plan = "plan" in inspect.signature(K.tile_spmm_csr_cuda).parameters
    if takes_plan:
        from repro_torch.kernels.tile_spmm.plan import csr_plan
    dev = torch.device("cuda")
    g = G.paper_graph("coAuthorsDBLP")
    indeg = np.bincount(g.dst, minlength=g.n_vertices)
    cases = {"all edges": np.ones(g.n_edges, bool),
             "without the largest hub": g.dst != int(indeg.argmax()),
             "without rows over 128 edges": indeg[g.dst] <= 128}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(0)
    full_ms = None
    for case, keep in cases.items():
        sub = G.Graph(src=g.src[keep], dst=g.dst[keep], n_vertices=g.n_vertices)
        ts = grid_tile(sub, 64, 64, sparse=True, layout="csr")
        T, E, S, P = ts.n_tiles, ts.e_max, ts.s_max, ts.n_dst_parts
        part_id = torch.as_tensor(ts.part_id, dtype=torch.int32, device=dev)
        flags = torch.as_tensor(K.tile_flags(ts.part_id), device=dev)
        row_ptr = torch.as_tensor(ts.row_ptr, dtype=torch.int32, device=dev)
        col = torch.as_tensor(ts.edge_src, dtype=torch.int32, device=dev)
        w = torch.randn((T, E), generator=gen, device=dev)
        xsrc = torch.randn((T, S, 128), generator=gen, device=dev)
        extra = dict(plan=csr_plan(row_ptr, part_id, P, E)) if takes_plan else {}
        ms = time_ms(lambda: K.tile_spmm_csr_cuda(row_ptr, col, w, xsrc, part_id,
                                                  flags, n_parts=P, **extra))
        full_ms = ms if full_ms is None else full_ms
        print(json.dumps(dict(tree=str(args.tree), case=case,
                              edges=int(keep.sum()), removed=int((~keep).sum()),
                              max_in_degree=int(np.bincount(
                                  sub.dst, minlength=g.n_vertices).max()),
                              ms=ms, share_of_full=1 - ms / full_ms,
                              plan_kernel=takes_plan, card=smi)), flush=True)
        del w, xsrc, extra
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
