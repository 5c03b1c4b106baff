"""The port's plain flash-attention and MoE-dispatch versions against
`repro`'s scan path, its Pallas kernels (interpret mode) and its MoE ops, on
the same numpy inputs.

The CUDA kernels run only on a card (`chip_smoke.py` holds each against
these plain versions there); on the CPU the dispatchers take the plain
versions, and the CUDA wrappers refuse CPU tensors.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.moe_dispatch import ops as jmoe
from repro.kernels.moe_dispatch.kernel import grouped_ffn_pallas
from repro_torch.kernels.flash_attention import kernel as tflash_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention as t_flash
from repro_torch.kernels.moe_dispatch import kernel as tmoe_kernel
from repro_torch.kernels.moe_dispatch import ops as tmoe
from repro_torch.kernels.moe_dispatch.ref import grouped_ffn_magnitude

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

FLASH_TOL = dict(atol=2e-5, rtol=2e-5)
MOE_TOL = dict(atol=2e-5, rtol=2e-4)

# the shapes of tests/test_kernels.py FLASH_SHAPES
FLASH_SHAPES = [
    # B, Sq, Sk, H, K, D, causal, window
    (2, 64, 64, 4, 2, 32, True, None),
    (1, 128, 128, 8, 8, 64, True, None),
    (2, 33, 97, 6, 3, 16, True, None),      # ragged, GQA
    (1, 64, 64, 4, 4, 32, False, None),     # bidirectional
    (2, 128, 128, 4, 2, 32, True, 48),      # sliding window
    (1, 1, 256, 8, 2, 64, True, None),      # decode
]


def _qkv(rng, B, Sq, Sk, H, K, D, Dv=None):
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, K, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, K, Dv or D)).astype(np.float32)
    return q, k, v


def _both(fn_t, fn_j, *arrays, **kw):
    got = fn_t(*(torch.as_tensor(a) for a in arrays), **kw)
    want = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window", FLASH_SHAPES)
def test_flash_plain_vs_scan_and_pallas(B, Sq, Sk, H, K, D, causal, window, rng):
    q, k, v = _qkv(rng, B, Sq, Sk, H, K, D)
    got, want = _both(t_flash, j_flash, q, k, v, causal=causal, window=window,
                      block_k=32)
    np.testing.assert_allclose(got, want, **FLASH_TOL)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, window=window,
                                    block_q=16, block_k=32)
    np.testing.assert_allclose(got, np.asarray(pallas), **FLASH_TOL)


# the families' attention shapes, cut down (B, Sq, Sk, H, K, D, causal,
# window, kv_len): whisper's cross-attention (Sq != Sk, not causal, a key
# count off the tiles), head dim 80 (zamba2) with a window, and a decode
# step on a ring cache with per-row kv_len and a window wider than it
FAMILY_FLASH = {"cross": (1, 24, 75, 4, 4, 16, False, None, None),
                "d80_window": (1, 64, 64, 4, 4, 80, True, 48, None),
                "ring_decode": (2, 1, 40, 4, 4, 80, False, 4096, [40, 17])}


@pytest.mark.parametrize("case", list(FAMILY_FLASH))
def test_flash_family_shapes_plain_vs_scan_and_pallas(case, rng):
    B, Sq, Sk, H, K, D, causal, window, kv = FAMILY_FLASH[case]
    q, k, v = _qkv(rng, B, Sq, Sk, H, K, D)
    kw = dict(causal=causal, window=window, block_k=32)
    kv_t = None if kv is None else torch.tensor(kv, dtype=torch.int32)
    kv_j = None if kv is None else jnp.asarray(kv, jnp.int32)
    got = t_flash(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                  kv_len=kv_t, **kw).numpy()
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=kv_j, **kw)
    np.testing.assert_allclose(got, np.asarray(want), **FLASH_TOL)
    if kv is None:   # the Pallas kernel takes no kv_len (kernel.py:88)
        pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        block_q=16, **kw)
        np.testing.assert_allclose(got, np.asarray(pallas), **FLASH_TOL)


@pytest.mark.parametrize("block_k", [8, 512])
def test_flash_mla_value_dim(block_k, rng):
    """MLA: qk head dim 48 against a value head dim of 32."""
    q, k, v = _qkv(rng, 2, 16, 16, 8, 8, 48, Dv=32)
    got, want = _both(t_flash, j_flash, q, k, v, causal=True, block_k=block_k)
    assert got.shape == (2, 16, 8, 32)
    np.testing.assert_allclose(got, want, **FLASH_TOL)


@pytest.mark.parametrize("Sq", [1, 3])
def test_flash_kv_len(Sq, rng):
    """Ragged decode: a 64-slot cache filled to a different length per row."""
    q, k, v = _qkv(rng, 3, Sq, 64, 4, 2, 32)
    kv_len = np.array([10, 64, 33], np.int32)
    got = t_flash(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                  causal=False, block_k=16, kv_len=torch.as_tensor(kv_len))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                   block_k=16, kv_len=jnp.asarray(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)


def test_flash_row_without_keys_is_the_mean_of_the_values(rng):
    """At (2, 65, 130, 4 / 2 heads, window 30, kv_len [100, 130]) the last
    query of batch 0 (position 129) keeps no key: its window (99, 129] lies
    past kv_len.  The plain version, like the scan path, gives the mean of
    all values there; the CUDA kernel, like the Pallas kernel, gives 0, so
    chip_smoke.py refuses a case with such a row."""
    q, k, v = _qkv(rng, 2, 65, 130, 4, 2, 32)
    kv_len = np.array([100, 130], np.int32)
    got = t_flash(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                  causal=True, window=30, kv_len=torch.as_tensor(kv_len))
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                   window=30, kv_len=jnp.asarray(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)
    mean = v[0].mean(0).repeat(2, axis=0)           # (H, D): KV head h // 2
    np.testing.assert_allclose(got.numpy()[0, -1], mean, **FLASH_TOL)
    keep = chip_smoke._flash_keep(2, 65, 130, True, 30, torch.as_tensor(kv_len), "cpu")
    assert keep.any(-1).sum() == 2 * 65 - 1 and not keep[0, -1].any()


# ---------------------------------------------------------------------------
# MoE routing, dispatch, grouped FFN, combine
# ---------------------------------------------------------------------------

# T tokens, d, E experts, f, top-k, capacity: ample, with drops, and with
# dead row blocks (capacity 40 over block_c 8 with few live rows)
MOE_CASES = [
    (32, 16, 4, 32, 2, 16),
    (48, 16, 8, 24, 2, 4),
    (20, 32, 6, 16, 3, 40),
]


def _moe_inputs(rng, T, d, E, f, bias=False):
    x = rng.standard_normal((T, d)).astype(np.float32)
    rw = (rng.standard_normal((d, E)) / np.sqrt(d)).astype(np.float32)
    wg = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32)
    wd = (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(np.float32)
    b = rng.standard_normal(E).astype(np.float32) if bias else None
    return x, rw, wg, wu, wd, b


@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("T,d,E,f,k,cap", MOE_CASES)
def test_route_dispatch_combine(T, d, E, f, k, cap, norm_topk, rng):
    x, rw, _, _, _, b = _moe_inputs(rng, T, d, E, f, bias=True)
    jr = jmoe.route(jnp.asarray(x), jnp.asarray(rw), k, cap, norm_topk=norm_topk,
                    router_bias=jnp.asarray(b))
    tr = tmoe.route(torch.as_tensor(x), torch.as_tensor(rw), k, cap,
                    norm_topk=norm_topk, router_bias=torch.as_tensor(b))
    for field in ("bucket_idx", "token_idx", "keep", "counts"):
        np.testing.assert_array_equal(getattr(tr, field).numpy(),
                                      np.asarray(getattr(jr, field)), err_msg=field)
    np.testing.assert_allclose(tr.weight.numpy(), np.asarray(jr.weight), **MOE_TOL)
    np.testing.assert_allclose(float(tr.aux_loss), float(jr.aux_loss), **MOE_TOL)

    jb = jmoe.dispatch(jnp.asarray(x), jr, E, cap)
    tb = tmoe.dispatch(torch.as_tensor(x), tr, E, cap)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    y = rng.standard_normal((E, cap, d)).astype(np.float32)
    np.testing.assert_allclose(tmoe.combine(torch.as_tensor(y), tr, T).numpy(),
                               np.asarray(jmoe.combine(jnp.asarray(y), jr, T)),
                               **MOE_TOL)


@pytest.mark.parametrize("T,d,E,f,k,cap", MOE_CASES)
def test_grouped_ffn_plain_vs_pallas(T, d, E, f, k, cap, rng):
    x, rw, wg, wu, wd, _ = _moe_inputs(rng, T, d, E, f)
    jr = jmoe.route(jnp.asarray(x), jnp.asarray(rw), k, cap)
    buckets = np.array(jmoe.dispatch(jnp.asarray(x), jr, E, cap))
    counts = np.minimum(np.asarray(jr.counts), cap).astype(np.int32)
    want = grouped_ffn_pallas(jnp.asarray(buckets), jnp.asarray(wg), jnp.asarray(wu),
                              jnp.asarray(wd), jnp.asarray(counts), block_c=8)
    got = tmoe.grouped_ffn(*(torch.as_tensor(a) for a in
                             (buckets, wg, wu, wd, counts)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    # rows at or past the live count are zero
    dead = np.arange(cap)[None, :] >= counts[:, None]
    assert not got.numpy()[dead].any()


@pytest.mark.parametrize("T,d,E,f,k,cap", MOE_CASES)
def test_moe_block_vs_pallas(T, d, E, f, k, cap, rng):
    x, rw, wg, wu, wd, _ = _moe_inputs(rng, T, d, E, f)
    jy, jaux = jmoe.moe_block(*(jnp.asarray(a) for a in (x, rw, wg, wu, wd)),
                              top_k=k, capacity=cap, use_pallas=True)
    ty, taux = tmoe.moe_block(*(torch.as_tensor(a) for a in (x, rw, wg, wu, wd)),
                              top_k=k, capacity=cap)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **MOE_TOL)


@pytest.mark.parametrize("wrapper,args", [
    (tflash_kernel.flash_attention_cuda, (3,)),
    (tmoe_kernel.grouped_ffn_cuda, (5,)),
])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper, args):
    zeros = [torch.zeros((1, 2, 2, 2)) for _ in range(args[0])]
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*zeros)


# the flash kernel's tile configurations at the shapes of chip_smoke.py's
# phases 6 and 7 (Sq, D, Dv): MLA and GQA prefill, the ragged and
# head-dim-256 checks, a decode step, the 8-token forward check; the vlm
# prefill (256 patches + 4,096 tokens), whisper's encoder, cross-attention
# and cross decode (head dim 64), zamba2's prefill and ring decode (head
# dim 80: one full 64-dim K chunk and a 16-dim one, Dv in two column groups)
PATH_FLASH = {"mla_prefill": ((4096, 192, 128), (8, 2, 187_392)),
              "gqa_prefill": ((4096, 128, 128), (8, 2, 154_624)),
              "gqa_ragged": ((1000, 128, 128), (8, 2, 154_624)),
              "window_d256": ((65, 256, 256), (4, 4, 136_192)),
              "gqa_decode": ((1, 128, 128), (1, 2, 65_024)),
              "forward_check": ((8, 192, 128), (1, 2, 69_120)),
              "vlm_prefill": ((4352, 128, 128), (8, 2, 154_624)),
              "whisper_encoder": ((1500, 64, 64), (8, 1, 121_856)),
              "whisper_cross": ((448, 64, 64), (8, 1, 121_856)),
              "whisper_cross_decode": ((1, 64, 64), (1, 1, 60_928)),
              "zamba_prefill": ((4096, 80, 80), (8, 2, 130_048)),
              "zamba_ring_decode": ((1, 80, 80), (1, 2, 61_952))}


@pytest.mark.parametrize("case", list(PATH_FLASH))
def test_flash_launch_config_at_the_path_shapes(case):
    """The wrapper picks the tile configuration; its dynamic shared memory
    fits an H100 block (227 KB) in fp32 and bf16."""
    (Sq, D, Dv), want = PATH_FLASH[case]
    assert tflash_kernel.launch_config(Sq, D, Dv, torch.float32) == want
    for dt in (torch.float32, torch.bfloat16):
        assert tflash_kernel.launch_config(Sq, D, Dv, dt)[2] <= tflash_kernel.MAX_SMEM
    assert tflash_kernel.MAX_SMEM == 232_448


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_launch_config_fits_every_head_dim(dtype):
    """Every (Sq, D, Dv) the wrapper accepts gets an instantiated
    configuration (rows in {1, 4, 8}, nv in {1, 2, 4}, no 8-row tile with
    nv 4) within the shared-memory limit."""
    for Sq in (1, 16, 17, 64, 65, 4096):
        for D in range(4, 257, 4):
            for Dv in (4, 64, 68, 128, 132, 192, 256):
                rows, nv, smem = tflash_kernel.launch_config(Sq, D, Dv, dtype)
                assert rows in (1, 4, 8) and nv in (1, 2, 4) and Dv <= 64 * nv
                assert not (rows == 8 and nv == 4)
                assert smem <= tflash_kernel.MAX_SMEM


# the grouped-FFN kernel's launch configurations: DeepSeek-V2's MoE layer at
# a 1,024-token prefill chunk and a 4-token decode step (E, C, d, f), the
# MOE_CASES buckets and chip_smoke.py's off-path cases
PATH_FFN = {"prefill_chunk": ((160, 48, 5120, 1536), (48, 2, 4, 158_720)),
            "decode": ((160, 8, 5120, 1536), (8, 4, 3, 101_760))}
FFN_SHAPES = ([shape for shape, _ in PATH_FFN.values()]
              + [(E, cap, d, f) for _, d, E, f, _, cap in MOE_CASES]
              + [(len(c["counts"]), c["C"], c["d"], c["f"]) for c in chip_smoke.FFN_OFF_PATH])


@pytest.mark.parametrize("case", list(PATH_FFN))
def test_grouped_ffn_launch_config_at_the_path_shapes(case):
    """One row tile covers the bucket (each live expert's weights are read
    once a launch), in 4 to 12 warps, within an H100 block's 227 KB."""
    (E, C, d, f), (rows, ksplit, slots, smem) = PATH_FFN[case]
    cfg = tmoe_kernel.launch_config(E, C, d, f, torch.float32)
    assert (cfg.rows, cfg.ksplit, cfg.slots, cfg.smem) == (rows, ksplit, slots, smem)
    assert cfg.rows >= C and cfg.cols == (128, 256)
    assert tmoe_kernel.launch_config(E, C, d, f, torch.bfloat16).smem <= smem
    assert tmoe_kernel.MAX_SMEM == 232_448


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,d,f", FFN_SHAPES)
def test_grouped_ffn_launch_config_fits_and_skips_dead_slices(E, C, d, f, dtype):
    """Every configuration fits the shared memory and the kernel's limits
    (1-8 slices, 1, 2 or 4 contraction shares, at most 12 warps); for every
    live count, each live row lies in a slice the grid covers, and the row
    slots issued are the live rows rounded up to the 8-row slice."""
    cfg = tmoe_kernel.launch_config(E, C, d, f, dtype)
    assert cfg.smem <= tmoe_kernel.MAX_SMEM
    assert 1 <= cfg.slices <= 8 and cfg.rows == 8 * cfg.slices
    assert cfg.ksplit in (1, 2, 4) and 4 <= cfg.threads // 32 <= 12
    assert 2 <= cfg.slots <= 4
    slices = tmoe_kernel.row_slices(C, cfg)
    covered = [r for r0, n in slices for r in range(r0, r0 + n)]
    assert covered == list(range(C))               # each row once, in order
    for n in range(C + 1):
        issued = tmoe_kernel.issued_rows([n], C, cfg)
        assert n <= issued <= -(-n // 8) * 8
    counts = list(range(C + 1))
    assert tmoe_kernel.issued_rows(counts, C, cfg) == sum(-(-n // 8) * 8 for n in counts)


def test_grouped_ffn_off_path_reaches_every_tail():
    """chip_smoke.py's off-path grouped-FFN cases reach the K tails (d and f
    not multiples of the 32-deep step), the column tails (f not a multiple
    of 128, d not of 256), a row slice cut by C, two row tiles, and counts
    of 0, C, a partial slice and a live expert with a dead slice."""
    cases = chip_smoke.FFN_OFF_PATH
    assert all(c["d"] % 8 == 0 and c["f"] % 8 == 0 for c in cases)
    assert any(c["d"] % 32 for c in cases) and any(c["f"] % 32 for c in cases)
    assert any(c["f"] % 128 for c in cases) and any(c["d"] % 256 for c in cases)
    configs = [tmoe_kernel.launch_config(len(c["counts"]), c["C"], c["d"], c["f"],
                                         torch.float32) for c in cases]
    assert any(c["C"] % cfg.rows for c, cfg in zip(cases, configs))
    assert any(c["C"] % 8 for c in cases)
    assert any(c["C"] > cfg.rows for c, cfg in zip(cases, configs))
    counts = [(n, c["C"]) for c in cases for n in c["counts"]]
    assert any(n == 0 for n, _ in counts) and any(n == C for n, C in counts)
    assert any(0 < n < C and n % 8 for n, C in counts)
    assert any(0 < n <= C - 8 for n, C in counts)


# ---------------------------------------------------------------------------
# chip_smoke.py's limits for the CUDA kernels: room above fp32 rounding, none
# for a wrong result
# ---------------------------------------------------------------------------

def _flash64(q, k, v, drop_diagonal=False):
    """Causal attention in float64; ``drop_diagonal`` masks each query's own
    key as well (an off-by-one fault)."""
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    q, k, v = q.double(), k.repeat_interleave(G, 2).double(), v.repeat_interleave(G, 2).double()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    q_pos = torch.arange(Sq)[:, None] + Sk - Sq
    keep = torch.arange(Sk)[None, :] <= q_pos
    if drop_diagonal:
        keep &= (torch.arange(Sk)[None, :] < q_pos) | (q_pos == 0)
    p = s.masked_fill(~keep, float("-inf")).softmax(-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _ffn64(x, wg, wu, wd, counts, silu=True):
    x, wg, wu, wd = (t.double() for t in (x, wg, wu, wd))
    g = torch.bmm(x, wg)
    y = torch.bmm((torch.nn.functional.silu(g) if silu else g) * torch.bmm(x, wu), wd)
    live = torch.arange(x.shape[1])[None, :] < counts[:, None]
    return torch.where(live[..., None], y, 0.0)


@pytest.mark.parametrize("kernel", ["flash_attention", "grouped_ffn"])
def test_chip_smoke_limits_pass_fp32_rounding_and_fail_faults(kernel, rng):
    """The plain version in fp32 stays within a fifth of the limit that
    chip_smoke.py sets for kernel vs plain (so two fp32 orders of summation
    pass), and results with a planted fault exceed it."""
    abs_tol, rel_tol = chip_smoke.LM_KERNEL_TOL[kernel]
    if kernel == "flash_attention":
        q, k, v = (torch.as_tensor(a) for a in _qkv(rng, 1, 128, 128, 4, 2, 192, Dv=128))
        got = t_flash(q, k, v, causal=True)
        magnitude = t_flash(q, k, v.abs(), causal=True)
        exact = _flash64(q, k, v)
        faults = {"diagonal key dropped": _flash64(q, k, v, drop_diagonal=True),
                  "scores scaled 1.001": _flash64(q * 1.001, k, v)}
    else:
        wg, wu, wd = (torch.as_tensor(a) for a in _moe_inputs(rng, 1, 512, 3, 256)[2:5])
        buckets = torch.as_tensor(rng.standard_normal((3, 16, 512)).astype(np.float32))
        counts = torch.tensor([16, 5, 0], dtype=torch.int32)
        args = (buckets, wg, wu, wd, counts)
        got = tmoe.grouped_ffn(*args)
        magnitude = grouped_ffn_magnitude(*args)
        exact = _ffn64(*args)
        row_zeroed = exact.clone()
        row_zeroed[1, 4] = 0
        faults = {"no silu": _ffn64(*args, silu=False), "live row zeroed": row_zeroed,
                  "gate and up swapped": _ffn64(buckets, wu, wg, wd, counts)}
    limit = abs_tol + rel_tol * magnitude.double()
    assert bool(((got.double() - exact).abs() <= limit / 5).all())
    for name, wrong in faults.items():
        assert bool(((wrong - exact).abs() > limit).any()), name
