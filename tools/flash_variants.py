"""Time variants of the flash-attention kernel's tiling constants on one card.

    python3 tools/flash_variants.py

Builds copies of ``src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu`` with other K-chunk widths (``kKC``), ring depths
(``kStages``), blocks a SM (the launch bounds' minimum) and query rows a
block, one ``nvcc`` each, side by side, into ``build/flash_variants/``.
Then times each (median of 10 CUDA-event-timed calls of the C entry point,
no Python wrapper) in fp32 at ``chip_smoke.py`` phase 6's flash shapes and
prints one JSON line per (case, variant) with its max abs difference from
the plain version.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_variants"

# name: (kKC, kStages, blocks a SM, query rows a thread or None for the
# wrapper's choice); the first is the shipped kernel
VARIANTS = {
    "kc64_st3": (64, 3, 1, None),
    "kc64_st2": (64, 2, 1, None),
    "kc32_st4": (32, 4, 1, None),
    "kc32_st3": (32, 3, 1, None),
    "kc16_st4": (16, 4, 1, None),
    "kc32_st4_rows4_1block": (32, 4, 1, 4),
    "kc32_st4_rows4_2blocks": (32, 4, 2, 4),
}
# case: B, Sq, Sk, H, K, D, Dv, causal, kv_len
CASES = {
    "mla_prefill": (1, 4096, 4096, 128, 128, 192, 128, True, None),
    "gqa_prefill": (1, 4096, 4096, 12, 2, 128, 128, True, None),
    "gqa_ragged": (1, 1000, 1000, 12, 2, 128, 128, True, None),
    "gqa_decode": (4, 1, 40, 12, 2, 128, 128, False, [40, 35, 30, 25]),
}


def source_of(text: str, kc: int, stages: int, blocks: int) -> str:
    for old, new in (("constexpr int kKC = 64;", f"constexpr int kKC = {kc};"),
                     ("constexpr int kStages = 3;", f"constexpr int kStages = {stages};"),
                     ("__launch_bounds__(kThreads, 1)",
                      f"__launch_bounds__(kThreads, {blocks})")):
        if old not in text:
            raise RuntimeError(f"the kernel source no longer has {old!r}")
        text = text.replace(old, new)
    return text


def time_ms(fn, runs: int = 10, warmup: int = 2) -> float:
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
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import SOURCE, launch_config
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    text = SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)

    def build(name):
        kc, stages, blocks, _ = VARIANTS[name]
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(source_of(text, kc, stages, blocks))
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
    gen = torch.Generator(device=dev).manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    for case, (B, Sq, Sk, H, K, D, Dv, causal, kv_list) in CASES.items():
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev)
        k = torch.randn((B, Sk, K, D), generator=gen, device=dev)
        v = torch.randn((B, Sk, K, Dv), generator=gen, device=dev)
        kv_len = (None if kv_list is None
                  else torch.tensor(kv_list, dtype=torch.int32, device=dev))
        want = flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len)
        out = torch.empty((B, Sq, H, Dv), device=dev)
        for name, lib in libs.items():
            kc, stages, _, rows_cap = VARIANTS[name]
            rows, nv, _ = launch_config(Sq, D, Dv, torch.float32)
            rows = min(rows, rows_cap or rows)
            smem = 4 * 16 * rows * (D + 4 + 68) + stages * 64 * (4 * kc + 16)
            fn = lib.zipper_flash_attention
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
                         B, Sq, Sk, H, K, D, Dv, int(causal), -1, 0, rows, nv, smem,
                         stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            print(json.dumps(dict(case=case, variant=name, kc=kc, stages=stages,
                                  rows=rows, blocks_per_sm=VARIANTS[name][2],
                                  smem=smem, ms=time_ms(call),
                                  max_abs_err=float((out - want).abs().max()),
                                  card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
