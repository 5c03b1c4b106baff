"""Split the grouped FFN's and the COO tile SpMM's time on one card.

    python3 tools/kernel_variants.py

Builds copies of ``src/repro_torch/kernels/moe_dispatch/csrc/grouped_ffn.cu``
and ``.../tile_spmm/csrc/tile_spmm.cu`` with parts of the work cut out, one
``nvcc`` each, side by side, into ``build/kernel_variants/``:

- grouped FFN ``gate_only``: the gate/up launch alone (the rest of the
  shipped time is the down launch);
- grouped FFN ``no_fma``: both launches stream their operands through the
  ring and meet at every barrier, but no warp runs its FMAs;
- grouped FFN ``no_stream``: only the ring's first slots are filled, so the
  FMAs run on stale tiles with no weight traffic after the prologue;
- grouped FFN ``one_x_load``: a warp reads one of its 8 rows' x values
  from shared memory and reuses it for the other 7 (the cost of the
  broadcast x reads);
- COO SpMM ``no_gather``: the warps sweep the adjacency and ballot, but
  list and gather no nonzero;
- COO SpMM ``loads{A}_gather{G}[_{B}_blocks]``: other constants, A
  adjacency pieces a lane before a ballot (shipped: 8), G x rows in flight
  (shipped: 8), registers capped for B blocks of 8 warps a SM.

(The cut-out conditions test a size against an impossible value, so the
compiler keeps what they guard.)  Times each, and the shipped source, at
``chip_smoke.py``'s main-path shapes (median of 10 CUDA-event-timed calls
of the C entry point, the shipped ``launch_config``), and prints one JSON
line per (kernel, case, variant) with the card's name and power limit.
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "kernel_variants"
FFN_CU = ROOT / "src/repro_torch/kernels/moe_dispatch/csrc/grouped_ffn.cu"
COO_CU = ROOT / "src/repro_torch/kernels/tile_spmm/csrc/tile_spmm.cu"

_COO_BOUNDS = "__global__ void __launch_bounds__(kThreads)\ncoo_spmm_kernel("


def _coo_constants(loads, gather, blocks):
    """Edits giving the COO SpMM ``loads`` adjacency pieces a lane before a
    ballot, ``gather`` x rows in flight and, if ``blocks``, registers capped
    for that many blocks a SM."""
    edits = [("constexpr int kAdjLoads = 8;", f"constexpr int kAdjLoads = {loads};"),
             ("constexpr int kGather = 8;", f"constexpr int kGather = {gather};")]
    if blocks:
        edits.append((_COO_BOUNDS, _COO_BOUNDS.replace("(kThreads)", f"(kThreads, {blocks})")))
    return [(o, n) for o, n in edits if o != n]


# name: (source, [(old, new), ...])
VARIANTS = {
    "ffn_shipped": (FFN_CU, []),
    "ffn_gate_only": (FFN_CU, [("  if (err != 0) return err;\n  return launch<float",
                                "  if (err != 0 || E > 0) return err;\n  return launch<float")]),
    "ffn_no_fma": (FFN_CU, [("    if (!active) continue;",
                             "    if (!active || Kd > 0) continue;")]),
    "ffn_no_stream": (FFN_CU, [("    if (next < steps) load(next, next % slots);",
                                "    if (next < steps && Kd < 0) load(next, next % slots);")]),
    "ffn_one_x_load": (FFN_CU, [("      for (int i = 0; i < kSlice; ++i) xv[i] = load4(xs + i * XS + k);",
                                 "      for (int i = 0; i < kSlice; ++i)\n"
                                 "        xv[i] = (i == 0 || Kd < 0) ? load4(xs + i * XS + k) : xv[0];")]),
    "coo_shipped": (COO_CU, []),
    "coo_no_gather": (COO_CU, [("        if (!__any_sync(kAll, nz)) continue;",
                                "        if (!__any_sync(kAll, nz) || F > 0) {\n"
                                "          n += (F < 0) * __popc(__ballot_sync(kAll, nz));\n"
                                "          continue;\n"
                                "        }")]),
    **{f"coo_loads{a}_gather{g}" + (f"_{b}_blocks" if b else ""): (COO_CU, _coo_constants(a, g, b))
       for a, g, b in ((4, 8, None), (6, 8, None), (8, 4, None), (8, 8, 3))},
}


def _kernel_ab():
    spec = importlib.util.spec_from_file_location("kernel_ab", ROOT / "tools" / "kernel_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_dispatch.kernel import launch_config
    ab = _kernel_ab()

    OUT.mkdir(parents=True, exist_ok=True)

    def build(name):
        src, edits = VARIANTS[name]
        text = src.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{src.name} no longer has {old!r}")
            text = text.replace(old, new)
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
        return name, ctypes.CDLL(str(so))

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(build, VARIANTS))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    (adj, xsrc, part_id, _, part_ptr, P, coo_want), ffn = ab.operands(dev)
    P_, I_ = ctypes.c_void_p, ctypes.c_int

    def emit(**kw):
        print(json.dumps(dict(card=card, **kw)), flush=True)

    T, D, S = adj.shape
    F = xsrc.shape[-1]
    out = torch.empty((P, D, F), device=dev)
    for name in [n for n in VARIANTS if n.startswith("coo_")]:
        fn = libs[name].zipper_tile_spmm_coo
        fn.argtypes = [P_] * 4 + [I_] * 4 + [P_]

        def call(fn=fn):
            if fn(adj.data_ptr(), xsrc.data_ptr(), part_ptr.data_ptr(), out.data_ptr(),
                  P, D, S, F, stream):
                raise RuntimeError(f"{name}: launch failed")
        call()
        torch.cuda.synchronize()
        emit(kernel="tile_spmm", case="serving", variant=name, ms=ab.time_ms(call, runs=10),
             max_abs_err=float((out - coo_want).abs().max()))
    for (case, dt), (args, want) in ffn.items():
        if dt != "float32":
            continue
        buckets, wg, wu, wd, counts = args
        E, C, d = buckets.shape
        f = wg.shape[-1]
        cfg = launch_config(E, C, d, f, buckets.dtype)
        y = torch.empty_like(buckets)
        act = torch.empty((E, C, f), device=dev)
        for name in ("ffn_shipped", "ffn_gate_only", "ffn_no_fma", "ffn_no_stream",
                     "ffn_one_x_load"):
            fn = libs[name].zipper_grouped_ffn
            fn.argtypes = [P_] * 7 + [I_] * 9 + [P_]

            def call(fn=fn):
                if fn(buckets.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                      counts.data_ptr(), act.data_ptr(), y.data_ptr(), E, C, d, f, 0,
                      cfg.slices, cfg.ksplit, cfg.slots, cfg.smem, stream):
                    raise RuntimeError(f"{name}: launch failed")
            call()
            torch.cuda.synchronize()
            emit(kernel="grouped_ffn", case=case, dtype=dt, variant=name,
                 ms=ab.time_ms(call, runs=10),
                 max_abs_err=float((y - want).abs().max()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
