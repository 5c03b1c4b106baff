"""Time both segment softmaxes of two trees in turns, and this tree's at
other constants, on one card.

    python3 tools/softmax_ab.py [--tree DIR] [--rounds N]

At ``chip_smoke.py``'s main-path shapes, width 128: the serving batch's
COO tiles (phase 4) and the coAuthorsDBLP stand-in's CSR tiles (phase 5),
scores from a seed with NaN in the padded slots, a random source replica.

- With ``--tree`` (an unpacked older tree whose softmax wrappers take the
  TPU kernels' operands: a dense (T, D, E) score block for COO, gathered
  (T, E, F) values for both): that tree's kernels on those operands and
  this tree's on per-edge operands with their edge plans (built outside the
  timing), in turns (older, this, this, older, ... for ``--rounds``
  rounds), each through its Python wrapper; and once, the time the older
  runner took to build those operands (the score densify, the value
  gather).
- This tree's kernel alone, through its C entry point.
- Copies of this tree's ``tile_spmm.cu`` with other constants, one
  ``nvcc`` each, side by side, into ``build/softmax_variants/``: source
  rows in flight a warp (shipped: 4) and registers capped for more blocks
  a SM, through the C entry point.

Each time is the median of 20 CUDA-event-timed calls.  Every result is
held against this tree's plan-walk plain version (max abs difference
printed).  Prints one JSON line per measurement with the card's name and
power limit.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import inspect
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "softmax_variants"
CU = ROOT / "src/repro_torch/kernels/tile_spmm/csrc/tile_spmm.cu"
_BOUNDS = "__global__ void __launch_bounds__(kThreads)\nsoftmax_plan_kernel("
_IN_FLIGHT = "constexpr int kSoftInFlight = 4;"


def _variant(in_flight=4, blocks=None):
    """Edits giving the softmax ``in_flight`` source rows in flight a warp
    and, if ``blocks``, registers capped for that many blocks a SM."""
    edits = [(_IN_FLIGHT, f"constexpr int kSoftInFlight = {in_flight};")]
    if blocks:
        edits.append((_BOUNDS, _BOUNDS.replace("(kThreads)", f"(kThreads, {blocks})")))
    return [(o, n) for o, n in edits if o != n]


# name: [(old, new), ...] edits of tile_spmm.cu
VARIANTS = {
    "shipped": [],
    **{f"in_flight_{r}" + (f"_{b}_blocks" if b else ""): _variant(r, b)
       for r, b in ((2, None), (8, None), (4, 6), (2, 8))},
}


def _kernel_ab():
    spec = importlib.util.spec_from_file_location("kernel_ab", ROOT / "tools" / "kernel_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_tree(tree: Path):
    """``tree``'s tile-kernel wrappers, imported afresh (built on load)."""
    for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(tree.resolve() / "src"))
    try:
        mod = importlib.import_module("repro_torch.kernels.tile_spmm.kernel")
    finally:
        sys.path.pop(0)
    mod.library()
    return mod


def build_variant(name):
    from repro_torch.kernels import _build
    text = CU.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"{CU.name} no longer has {old!r}")
        text = text.replace(old, new)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(text)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    regs = [ln.strip() for ln in proc.stdout.splitlines() + proc.stderr.splitlines()
            if "registers" in ln]
    return name, ctypes.CDLL(str(so)), regs


def cases(dev):
    """Per layout: the tiles' operands of both trees and the plain result."""
    import torch
    from repro_torch.core.tiling import grid_tile
    from repro_torch.gnn import graphs as G
    from repro_torch.kernels.tile_spmm import kernel as K
    from repro_torch.kernels.tile_spmm import ops, ref
    from repro_torch.kernels.tile_spmm.plan import coo_plan, csr_plan
    from repro_torch.serve import ShapeRegistry

    gen = torch.Generator(device=dev).manual_seed(0)
    graphs = [G.random_graph(2000, 16000, seed=i, model="powerlaw") for i in range(16)]
    _, coo_tiles, _, _ = ShapeRegistry().canonical("shapes", G.batch_graphs(graphs).graph)
    csr_tiles = grid_tile(G.paper_graph("coAuthorsDBLP"), 64, 64, sparse=True, layout="csr")
    out = {}
    for ts in (coo_tiles, csr_tiles):
        T, E, S, P = ts.n_tiles, ts.e_max, ts.s_max, ts.n_dst_parts
        D = int(ts.part_size.max())

        def i32(a):
            return torch.as_tensor(a, dtype=torch.int32, device=dev)
        pid, col, ne, ed = i32(ts.part_id), i32(ts.edge_src), i32(ts.n_edge), i32(ts.edge_dst)
        pad = torch.arange(E, device=dev)[None, :] >= ne[:, None]
        s_e = torch.randn((T, E), generator=gen, device=dev).masked_fill_(pad, float("nan"))
        xsrc = torch.randn((T, S, 128), generator=gen, device=dev)
        tile = torch.arange(T, device=dev)[:, None]
        c = dict(T=T, E=E, S=S, P=P, D=D, pid=pid, col=col, s_e=s_e, xsrc=xsrc,
                 flags=i32(K.tile_flags(ts.part_id)),
                 part_ptr=i32(K.partition_ptr(ts.part_id, P)),
                 gather=lambda xsrc=xsrc, tile=tile, col=col: xsrc[tile, col.long()])
        if ts.layout == "csr":
            c["row_ptr"] = i32(ts.row_ptr)
            c["plan"] = csr_plan(c["row_ptr"], pid, P, E)
            c["dense"] = None
        else:
            c.update(edge_dst=ed, n_edge=ne)
            c["plan"] = coo_plan(ed, ne, pid, P, D)
            c["dense"] = lambda s_e=s_e, ed=ed, ne=ne, D=D: ops.densify_edge_scores(
                s_e, ed.long(), ne.long(), dmax=D)
        c["want"] = ref.segment_softmax_plan_ref(c["plan"], col, s_e, xsrc, P,
                                                 coo=ts.layout == "coo")
        out[ts.layout] = c
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("softmax_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    time_ms = _kernel_ab().time_ms
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()

    def emit(**kw):
        print(json.dumps(dict(card=card, **kw)), flush=True)

    trees = {"this": load_tree(ROOT)}
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        variants = list(pool.map(build_variant, VARIANTS))
    layouts = cases(dev)
    if args.tree is not None:
        trees = {"older": load_tree(args.tree), **trees}

    def wrapper_call(K, c, layout):
        takes_vals = "vals" in inspect.signature(K.segment_softmax_csr_cuda).parameters
        if takes_vals:                     # the TPU kernels' operands
            vals = c.setdefault("vals", c["gather"]())
            if layout == "csr":
                return lambda: K.segment_softmax_csr_cuda(
                    c["row_ptr"], c["s_e"], vals, c["pid"], c["flags"],
                    n_parts=c["P"], part_ptr=c["part_ptr"])
            dense = c.setdefault("dense_block", c["dense"]())
            return lambda: K.segment_softmax_cuda(dense, vals, c["pid"], c["flags"],
                                                  n_parts=c["P"], part_ptr=c["part_ptr"])
        if layout == "csr":
            return lambda: K.segment_softmax_csr_cuda(
                c["row_ptr"], c["col"], c["s_e"], c["xsrc"], c["pid"], c["flags"],
                n_parts=c["P"], plan=c["plan"])
        return lambda: K.segment_softmax_cuda(
            c["edge_dst"], c["n_edge"], c["col"], c["s_e"], c["xsrc"], c["pid"],
            c["flags"], n_parts=c["P"], dmax=c["D"], plan=c["plan"])

    order = list(trees) + list(trees)[::-1]
    for rnd in range(args.rounds):
        for tree in order:
            for layout, c in layouts.items():
                fn = wrapper_call(trees[tree], c, layout)
                emit(kernel="segment_softmax" + ("_csr" if layout == "csr" else ""),
                     layout=layout, tree=tree, round=rnd, ms=time_ms(fn),
                     max_abs_err=float((fn() - c["want"]).abs().max()))
    if "older" in trees:
        for layout, c in layouts.items():
            emit(layout=layout, old_operands="value gather (T, E, F)",
                 ms=time_ms(c["gather"], runs=5))
            if c["dense"] is not None:
                emit(layout=layout, old_operands="score densify (T, D, E)",
                     ms=time_ms(c["dense"], runs=5))
            c.pop("vals", None)
            c.pop("dense_block", None)
        torch.cuda.empty_cache()

    # this tree's kernel alone, and its variants, through the C entry point
    stream = torch.cuda.current_stream().cuda_stream
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    for name, lib, regs in variants:
        emit(variant=name, ptxas=[r for r in regs if "softmax" in r or "Used" in r][:8])
        fn = lib.zipper_segment_softmax
        fn.argtypes = [P_] * 11 + [I_] * 8 + [P_]
        for layout, c in layouts.items():
            plan, P, D = c["plan"], c["P"], c["D"]
            F = c["xsrc"].shape[-1]
            buf = torch.empty((P * D + plan.n_partial, F), device=dev)
            ml = torch.empty((plan.n_partial, 2), device=dev)

            def call(fn=fn, c=c, plan=plan, buf=buf, ml=ml, P=P, D=D, F=F, layout=layout):
                if fn(plan.slot.data_ptr(), plan.edge_tgt.data_ptr(),
                      plan.group_ptr.data_ptr(), plan.zero_row.data_ptr(),
                      c["col"].data_ptr(), c["s_e"].data_ptr(), c["xsrc"].data_ptr(),
                      plan.split_row.data_ptr(), plan.split_ptr.data_ptr(),
                      buf.data_ptr(), ml.data_ptr(), plan.group_ptr.numel() - 1,
                      plan.zero_row.numel(), plan.split_row.numel(), P * D,
                      c["E"], c["S"], F, int(layout == "coo"), stream):
                    raise RuntimeError(f"{name}: launch failed")
            call()
            torch.cuda.synchronize()
            err = float((buf[:P * D].view(P, D, F) - c["want"]).abs().max())
            emit(variant=name, layout=layout, entry="C", ms=time_ms(call),
                 max_abs_err=err)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
