#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line or more:

1. device: the card's name and power limit (``nvidia-smi``), torch version;
2. build: compile the four ``csrc/*.cu`` sources for sm_90a side by side
   (one ``nvcc`` each), with the seconds taken and ``ptxas``' report;
3. kernel checks: each of the four CUDA tile kernels against its plain
   PyTorch version on the card, at the shapes of phases 4 and 5, with its
   median time over CUDA-event-timed runs, the plain version's time, the
   time of one PyTorch library call where one exists, and its bound; the
   edge plans are built first (their build times and host syncs are
   fields of their rows); the COO SpMM, given its partition runs, and the
   plan-walking kernels, given their plans, run once each with host syncs
   made errors; both segment softmaxes run on per-edge operands (padded
   slots NaN) against the plan walk; the CSR kernels take their source
   operand first as the whole-graph pass gives it, the flat (V, F) store
   read through global columns (every row no edge names NaN), which the
   ``kernels`` line times, then as the (T, S, F) replica of its rows, which
   must give the same bits; the COO SpMM also runs at the
   off-path shapes of ``COO_OFF_PATH``, the softmaxes at those of
   ``SOFTMAX_OFF_PATH``;
4. serving (COO tiles): ``InferenceServer`` on 2-layer gcn and gat at width
   128 over a batch of 16 power-law graphs (2,000 vertices, 16,000 edges
   each), submitted three times — one build, then cache hits — against the
   whole-graph oracle ``run_reference`` on the card, with the COO edge
   plan's build time (each gat submit builds one at bind);
5. whole graph (CSR tiles): ``run_pipelined`` on the coAuthorsDBLP stand-in
   (299,068 vertices, 977,676 edges) for 2-layer gcn and gat at width 128,
   against ``run_reference``;
5b. R-GCN as published on the stand-in with inverse edges, at the
   benchmark cell rgcn2-dblp-rel-whole's shapes (1,955,352 messages, 206
   relations drawn by the cell's Zipf law, 40 bases, width 128): the
   relation-grouped edge GEMM against its plain version, reading its rows
   in place from the (299,068, 128) table, element by element within
   ``2 gamma_F sum |x w|``, once with host syncs made errors, timed beside
   the plain version and its bound; its backward (dx through the same
   kernel, dW through the weight-gradient kernel), element by element within
   ``2 gamma_n`` of its sums' magnitude and within ``sqrt(n) u`` of its
   largest entry; then one pass
   of ``PipelinedRunner`` (CSR tiles, kernel dispatch on) with the
   kernel's launches counted around it, against ``run_reference`` on the
   card (``MODEL_TOL``), and the gradients of a probe through it (four
   GEMM and two weight-gradient launches), each leaf within
   ``GRAD_PLAIN_MULTIPLE`` times the distance of the same runner's
   gradients with the plain versions from the fp64 oracle's;

6. LM kernel checks: the flash-attention and grouped-FFN kernels against
   their plain versions, in fp32 and bf16, at phase 7's shapes — flash
   (1, 4096, 128, 192 / v 128) causal (DeepSeek-V2 MLA prefill), (1, 4096,
   12, 128) with 2 KV heads causal (Qwen2-1.5B prefill), (4, 1, 12, 128)
   against a 40-slot cache with ``kv_len`` (its decode), (1, 4352, 64, 128)
   with 8 KV heads causal (Qwen2-VL: 256 patches + 4,096 tokens), (1, 1500,
   20, 64) not causal (Whisper's encoder), 448 queries against 1,500 keys
   not causal (its cross-attention) and (4, 1, 20, 64) against them (a
   decode step's), (1, 4096, 32, 80) causal with window 4,096 (Zamba2's
   shared block) and (4, 1, 32, 80) against its 40-slot ring cache with
   ``kv_len``; grouped FFN over
   (160, 48, 5120) buckets with f 1536 and the live counts of a real
   routing of a 1,024-token prefill chunk, and over (160, 8, 5120) for a
   4-token decode step — plus two flash cases off the path: a causal GQA
   prefill of 1,000 tokens, whose length fits neither the query tile nor
   the key tile, and (2, 65 queries, 130 keys, 4 / 2 heads, head dim 256,
   causal, window 30, ``kv_len``), with the same timings and bounds as
   phase 3; the grouped FFN also at the off-path shapes of
   ``FFN_OFF_PATH``; elementwise limits scaled by each sum's rounding
   magnitude (see ``LM_KERNEL_TOL``); one flash call and one grouped-FFN
   call with host syncs made errors; then the backward of both kernels'
   autograd Functions (kernel forward, PyTorch ops backward) against
   autograd through the plain versions, in fp32 and bf16, gradient by
   gradient (``LM_BWD_TOL``): flash at the training shapes of phase 12
   (qwen2 4 x 1,024 GQA, DeepSeek-V2 1 x 512 MLA, causal), the grouped FFN
   at the prefill-chunk shape;
7. LM serving, all six families at full width with random weights from a
   seed in the templates' dtype (bf16; the ssm / hybrid recurrent states in
   fp32), and qwen2-1.5b once more in fp32: qwen2-1.5b (all 28 layers),
   deepseek-v2-236b (depth cut to 2 layers: the leading dense layer and one
   MoE layer), qwen2-vl-72b (depth cut to 2 layers), whisper-large-v3 (32 +
   32 layers), xlstm-1.3b (48) and zamba2-2.7b (54); ``serve_requests`` with
   ``launch/serve.py``'s defaults (8 requests, batch 4, prompts of 4-24
   tokens from ``default_rng(0)``, 16 new tokens), tokens/s and the median
   decode-step latency; teacher-forced decode of an 8-token prompt against
   ``forward`` at every position (vlm without patches, audio with the
   cross cache filled from the encoder's K/V; in fp32 2e-3 dense-style,
   5e-3 MLA, ssm and hybrid, scaled by max(1, |ref|): the reference's own
   tolerances; in bf16 ``BF16_MODEL_MULTIPLE`` x the model's bf16-vs-fp32
   forward error on the same weights on top); ``make_prefill_step`` on one
   prompt (4,096 tokens; vlm
   with 256 patch embeddings before them; whisper 448 tokens over 1,500
   frames; xlstm 1,024 tokens, its sLSTM a step per token), twice (first
   and warm seconds) with its peak memory; a ``torch.profiler`` breakdown
   of 8 decode steps and a prefill; the flash launches of each model;
   then xlstm-1.3b and zamba2-2.7b at their widths cut to one super-block
   of two blocks, in bf16: decode vs forward within
   ``BF16_MODEL_MULTIPLE`` x the reference's own bf16 error there
   (``BF16_REF_ERR``, from ``tools/bf16_drift.py``) + the fp32 limit, and
   the port's bf16-vs-fp32 forward error within that multiple of it;
8. tiled: ``run_tiled`` (one call of the tile interpreter) on phase 4's
   batch padded by the server's ``ShapeRegistry`` (40,000 V), tiled as
   served (COO) and by ``grid_tile(64, 64, layout="csr")``, 2-layer gcn
   and gat at width 128, kernel dispatch on and off, each pass twice
   (first and warm seconds), against ``run_reference``;
9. async serving: ``AsyncInferenceServer`` with 2-layer gcn and gat
   (``max_batch=16``, warmed on the class), 64 single-graph requests of
   the class to each model with a 2 s deadline; the ``ServeMetrics``
   snapshot, 0 builds after warm-up, 4 sampled requests a model against
   ``run_reference`` of their graph;
10. autotune: ``tune_for_class`` for 2-layer gcn on phase 4's merged graph
   (24 simulator evaluations, the 2 finalists timed 5 times each by CUDA
   events on the card), then the class served through
   ``InferenceServer(tune_cache=...)``: the tuned registration key, the
   outputs against ``run_reference``, no build on a repeat submit;
11. sharded: ``ShardedRunner`` on a mesh of 4 logical shards of one card
   (``[cuda:0] * 4``, named explicitly: a one-card mesh is a repeated
   list) — the coAuthorsDBLP stand-in on phase 5's CSR tiles, mincut plan,
   2-layer gcn and gat against ``run_reference``, counted exchanges a pass
   against ``exchange_census``, ``verify_exchange`` clean, the rows the
   restricted exchange ships against the full layout, warm seconds (median
   of 3) beside ``run_pipelined``'s on the same tiles, peak memory; phase
   4's batch through ``InferenceServer(shard_devices=4)`` for gcn and gat
   against the unsharded server (0 builds after warm-up, every batch
   sharded); on the batch's padded graph a 2 x 2 ("shards", "model") gcn
   pass and a 4-shard scan pass of sage (rows with in-degree >= 1: ROADMAP
   C.1) against ``run_reference``, and a 2-shard ``confirm_wallclock``
   finalist on ``[cuda:0] * 2``;
12. training: the first two ``make_train_step`` calls on a 2-layer fp32
   cut of qwen2-1.5b (4 x 1,024 tokens) with the kernels against the same
   steps with attention through the plain version, params included
   (``TRAIN_PARITY_TOL``); the fp32 loss and gradients of deepseek-v2 x2
   (1 x 512) with both kernels against both plain versions; 4 steps
   of qwen2-1.5b (28 layers, 4 x 1,024 tokens) and deepseek-v2 x2 (full
   width, 1 x 512) in bf16 with fp32 moments: finite losses, step seconds,
   tokens/s, peak memory, the device busy share of a step
   (``torch.profiler``); then a checkpoint of a 2-layer bf16 cut after step
   1, restored bit for bit, and step 2 from it equal to step 2 without it;
13. GNN training (``launch/train_gnn.py``, ``examples/train_gnn.py``'s
   counterpart, fp32): the example's 3-layer GCN at width 512 on its graph
   (4,000 vertices, 16,000 power-law edges, 4 x 4 tiles), the loss and
   gradients through ``PipelinedRunner``'s scan path against autograd
   through ``run_reference``, leaf by leaf, then two ``gnn_train_step``s of
   each (losses, moments, params by ``_adamw_param_limit``;
   ``GNN_GRAD_TOL``); 20 steps at width 8192 (67.8 M params) on that graph
   and on ``paper_graph("ak2010")`` (45,293 / 108,549): losses finite and
   falling at the end, the median warm step by CUDA events, vertices x
   epochs a second, peak memory, the device busy share of a step and its
   largest device ops (``torch.profiler``); then on 8 x 8 tiles of the
   example's graph, where padded edge slots read rows without an edge,
   2-layer gat and gcn (width 128) gradients through the scan path and
   through ``ShardedRunner`` over ``[cuda:0] * 4`` against
   ``run_reference``'s, 1-layer gin with kernel dispatch on COO and CSR
   tiles against the scan path and one ``gnn_train_step`` through each
   SpMM kernel, and 1-layer gcn and gat with kernel dispatch, which must
   refuse a gradient (``NotImplementedError``);
14. the mesh across processes and expert-parallel MoE: one NCCL rank
   (``init_process_group`` on a ``FileStore`` under ``build/``; the card
   holds one, and NCCL refuses two ranks on a GPU, so this checks the code
   path and says nothing about scaling) running 2-layer gcn and gat on
   phase 5's CSR tiles through ``ShardMesh.from_process_group()``, bit for
   bit against the one-process single-shard run with the census's
   exchanges, every group collective (fp8 ``all_to_all`` included) and
   deepseek-v2's MoE layer (full width, 1 x 512) through the group mesh
   against the one-process mesh, then ``compressed_psum`` on deepseek-v2
   x2's gradient shapes
   (bf16, a leaf at a time) bit for bit against ``dequantize(quantize(g))``
   and its residual; then ``lm.forward(mesh=...)`` of deepseek-v2 x2 (full
   width, bf16, a 1 x 512 prefill) over (data, model) meshes of logical
   shards of the card — (1, 1), (2, 1), (4, 1), (2, 2), and (2, 2) under
   ``moe_rs_combine`` and under ``moe_fp8_dispatch`` — the grouped FFN at
   each mesh's shapes against its plain version (``LM_KERNEL_TOL``),
   ``mesh=None`` against itself and (1, 1) against it bit for bit (ROADMAP
   C.8's repair: no deterministic-algorithms switch), with dropped
   assignments, collectives, flash and grouped-FFN launches per forward,
   seconds and peak memory;
15. the LM sharded by its specs (tensor parallel over model, data parallel
   over data) on logical ranks of the card (``[cuda:0] * K``), which
   measures no scaling: 15a qwen2-1.5b (bf16, 28 layers) at (data, model)
   (1, 4) and (2, 2), a 1 x 4,096 forward against ``mesh=None`` at phase
   7's bf16 limit, collectives a forward against the count reckoned from
   the layers, rank 0's parameter bytes, ``serve_requests`` on the sharded
   KV cache at phase 7's load (8 requests, batch 4, 16 new tokens; decode
   step p10 / p50 / p90) and decode against the mesh forward, and the fp32 2-layer cut
   against ``mesh=None`` at ``TRAIN_PARITY_TOL``; 15b smollm-135m (9 heads
   on a 4-wide model axis, 8 x 512) at (2, 4) with ``attn_batch_shard`` off
   and on; 15c deepseek-v2 x2 at (2, 2) (tensor-parallel MLA and shared
   experts, expert-parallel MoE), 1 x 512 against ``mesh=None`` routing the
   same blocks, the absorbed decode on the sequence-sharded latent cache;
   15d qwen2-1.5b trained 2 steps at (2, 2), plain and under
   ``zero1_opt_state`` + ``fsdp_params`` with 2 microbatches (step s,
   tokens/s, peak memory, moment bytes a rank) and the fp32 2-layer cut's
   two steps against ``mesh=None``'s under both; 15e one train step of that
   cut through ``ShardMesh.from_process_group()`` on one NCCL rank, bit for
   bit against the one-process (1, 1) mesh.  Each kernel that 15a-d's
   meshed calls launch is held against its plain version (``LM_KERNEL_TOL``)
   on the inputs of the last call of each shape and option they made:
   flash at each rank's local heads or batch block, the grouped FFN at
   15c's buckets;
16. the recurrent and encoder-decoder families on a mesh of logical ranks
   (``[cuda:0] * 4``, no scaling measured): 16a whisper-large-v3, 16b
   xlstm-1.3b, 16c zamba2-2.7b (bf16, seed-0 weights, full width and
   depth) at (1, 4) with batch 1 and (2, 2) with batch 2, phase 7's prefill
   lengths (whisper 448 with 1,500 frames, xlstm 1,024, zamba2 4,096): the
   forward against ``mesh=None`` at phase 7's bf16 rule, collectives against
   :func:`family_collectives`, rank 0's bytes and peak memory, decode of
   ``TP_CHECK_LEN`` steps on the sharded cache (whisper's cross cache filled
   from the meshed encoder) against the meshed forward, ``serve_requests``
   at phase 7's load at (1, 4); xlstm / zamba2 also cut to one super-block
   against 3 x ``BF16_REF_ERR``; each family's depth cut (one super-block,
   whisper 2 + 2 layers) trained two fp32 steps at (2, 2) against
   ``mesh=None`` at ``TRAIN_PARITY_TOL`` (zamba2 also under ZeRO-1 + FSDP);
   16d deepseek-v2 x2 trained two fp32 steps with 8-bit AdamW moments at (2,
   2) against ``mesh=None`` 8-bit (:func:`moments_agreement`).  The kernels
   16a-d launch are held against their plain versions as 15's are;
17. the dry run (``launch/dryrun.py``: rank 0 of a mesh on the meta
   device) against the card: 17a one bf16 train step of qwen2-1.5b (28
   layers, 4 x 1,024) and one bf16 prefill of deepseek-v2 x2 (1 x 512)
   through ``ShardMesh.from_process_group()`` on one NCCL rank, each with
   its FLOPs counted by the dry run's counter (``dryrun.StepCounter``) and
   its peak memory (``max_memory_allocated`` above what was allocated
   before its inputs), against the dry run of the same cells on
   ``ShardMesh.abstract(1, 1)``: FLOPs equal, peak within
   ``DRYRUN_PEAK_TOL``; 17b two production cells of the dry run timed on
   the host, qwen3-32b ``train_4k`` on 16 x 16 and deepseek-v3-671b
   ``decode_32k`` on 2 x 16 x 16 (per-rank GB, whether it fits the card,
   TFLOP a rank, collective GB by kind); 17c the four example modules
   (``launch/quickstart.py``, ``kernel_path_demo.py``, ``serve_gnn.py``,
   ``serve_async.py``) at their default sizes on the card, each holding
   its results against its oracle.

Launch counters are set to 0 before phase 4 and read after phase 5 (the
relation GEMM's around phase 5b's runner pass), set to
0 again before phase 7 and read after it, and likewise around each of
phases 8, 9 and 10, around phase 12's two full-size training runs and
around each of phase 13's gin steps and phase 14's two parts; phases 11,
14, 15a-d and 16a-d add up the launches of their sharded or meshed calls
alone, leaving out the baselines and kernel checks they run beside them.  Every kernel must have launched on its path (in phases 8 and 11 all
four tile kernels; in phase 7 flash on every family but ssm; in phase 12
flash for both models, the grouped FFN for deepseek; in phase 13 the COO
SpMM on COO tiles and the CSR SpMM on CSR tiles; in phase 14 the CSR
SpMM and softmax on the process group, flash and the grouped FFN on the
meshes; in phase 15 flash in each of 15a-d, the grouped FFN in 15c; in
phase 16 flash in 16a, 16c and 16d, the grouped FFN in 16d; in phase 17
flash in both calibration steps, the grouped FFN in the prefill, the COO
SpMM and COO softmax in the kernel-path demo, counted around each).  Then one
``{"kernels": [...]}`` line (all seven,
launches of phases 4-5b and 7), the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": ...}``.
Any failure raises, so the exit code is nonzero and no ``ok`` line prints;
so does a machine without a visible CUDA device.  Weights and inputs come
from fixed seeds.  TF32 off; the GNN phases are fp32, the LM phases bf16
(phase 6 checks both dtypes, phase 7 serves qwen2-1.5b in fp32 too).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
# |kernel - plain| <= abs + rel * (the plain version over |inputs|): both sum
# in fp32 in another order, and that difference scales with the terms'
# magnitudes, not with the result (a high-degree row's sum cancels)
KERNEL_TOL = (1e-4, 1e-4)
MODEL_TOL = {"gcn": 5e-4, "gat": 1e-4, "sage": 5e-4,    # vs the oracle, x max(1, |ref|)
             "rgcn": 5e-4}
WIDTH = 128                    # the paper's embedding size (EMBED)
SOURCE = "src/repro_torch/kernels/tile_spmm/csrc/tile_spmm.cu"
RELATION_SOURCE = "src/repro_torch/kernels/relation_gemm/csrc/relation_gemm.cu"
REPLACES = {
    "tile_spmm": "src/repro/kernels/tile_spmm/kernel.py:67",
    "tile_spmm_csr": "src/repro/kernels/tile_spmm/kernel.py:172",
    "segment_softmax": "src/repro/kernels/tile_spmm/kernel.py:262",
    "segment_softmax_csr": "src/repro/kernels/tile_spmm/kernel.py:234",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:112",
    "grouped_ffn": "src/repro/kernels/moe_dispatch/kernel.py:57",
    # no Pallas kernel: the reference's einsum over a weight gathered per edge
    "relation_gemm": "src/repro/core/executor.py:46",
}
# phase 5b: R-GCN as published at the cell rgcn2-dblp-rel-whole's sizes
# (gnnbench/configs/rgcn2-b40-w128.json, gnnbench/traffic/dblp-rel-whole.json):
# 103 relations and their inverses, 40 bases, each canonical edge's relation
# drawn by a Zipf law of exponent 1.0 with seed 0
RGCN = dict(relations=206, bases=40, zipf=1.0, relation_seed=0)
# its gradients through the runner, each leaf's distance from the fp64
# oracle's, with the kernels at most this many times the plain versions'
# in the same runner (0.89-1.13 on an H100 at these shapes; PERF.md §6)
GRAD_PLAIN_MULTIPLE = 1.5
LM_SOURCES = {
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "grouped_ffn": "src/repro_torch/kernels/moe_dispatch/csrc/grouped_ffn.cu",
}
# |kernel - plain| <= abs + rel * magnitude (+ BF16_ULP * |plain| in bf16),
# elementwise.  Both sides compute in fp32 from the same inputs, so in fp32
# they differ only by the order of their sums, whose rounding scales with the
# magnitude: what the sums' terms add up to in absolute value (flash: the
# plain version on |v|; grouped FFN: ffn_magnitude, stage by stage, with the
# gate/up errors carried through silu).  The magnitude bounds rounding errors
# that all align; real ones random-walk far below it: the plain versions in
# fp32 against fp64 at these shapes differ by 1.1e-6 of it (flash, where an
# error in a score moves its exp) and 1.2e-9 (grouped FFN), so rel leaves
# 5-80x room and still fails a wrong row by orders of magnitude.  In bf16 the
# same fp32 results are rounded to bf16, and two nearby fp32 values may
# round to neighbours one unit in the last place apart: 2^-7 of |plain|.
LM_KERNEL_TOL = {"flash_attention": (1e-6, 1e-5), "grouped_ffn": (1e-6, 1e-7)}
BF16_ULP = 2.0 ** -7
# decode vs forward, x max(1, |ref|): the reference's own tolerances
# (tests/test_archs_smoke.py:80,99,117,134), dense-style 2e-3
LM_MODEL_TOL = {"dense": 2e-3, "vlm": 2e-3, "audio": 2e-3, "moe": 5e-3, "ssm": 5e-3,
                "hybrid": 5e-3}
# The backward of both LM kernels' autograd Functions (the kernel forward,
# PyTorch ops backward) against autograd through the plain version, held the
# same way: abs + rel * the backward's rounding magnitude built stage by
# stage (``flash_attention_bwd_magnitude``, ``grouped_ffn_bwd_magnitude``)
# + one bf16 ulp of |plain| in bf16, and for flash in bf16 the bound on what
# reading the forward's bf16 output in ``delta`` moves the gradients by
# (``flash_attention_delta_error`` at one ulp, BF16_ULP, of |o|; the plain
# version's autograd never rounds o).  On the CPU the backward in fp32 against
# fp64 gradients differs by at most 8.4e-8 of that magnitude (S up to 1,024
# keys; tests/test_torch_lm_bf16.py holds it and fails planted faults), so
# rel 1e-5 leaves over 100x for the card's other order of summation.
LM_BWD_TOL = {"flash_attention": (1e-6, 1e-5), "grouped_ffn": (1e-6, 1e-5)}
# bf16 serving, decode vs forward: both runs round in bf16, each by about
# the amount the model's bf16 forward differs from its fp32 forward on the
# same weights (e_model), so |decode - forward| <= 2 e_model by the triangle
# inequality, plus one e_model for the places where the two paths round
# differently (a step at a time against the whole prompt), plus the fp32
# limit above; tests/test_torch_lm_bf16.py holds the port to the reference
# by the same rule.
BF16_MODEL_MULTIPLE = 3
# The limit above is the model's own, and at full depth xlstm's and
# zamba2's random-weight bf16 forwards lie 0.66 / 0.39 of max|logit| from
# fp32, where it tests little; the reference drifts as far there
# (tools/bf16_drift.py, reduced widths at 48 / 54 layers, seeds 0-2: e_ref
# 0.34-0.62 / 0.12-0.17, the port on the same weights 0.51-0.63 /
# 0.11-0.16).  So both
# are also held at their published widths cut to one super-block of two
# blocks (``recurrent_bf16_check``) against the reference's own bf16 error
# on the same weights and tokens: max|ref_bf16 - ref_fp32| /
# max(1, max|ref_fp32|), tools/bf16_drift.py full_width_cut seed 0 on the
# CPU, whose weights have the fingerprint BF16_REF_WEIGHTS.
BF16_REF_ERR = {"xlstm-1.3b": 0.029539150956949527, "zamba2-2.7b": 0.027502965531050954}
BF16_REF_WEIGHTS = {"xlstm-1.3b": "90cafda8cd13150a", "zamba2-2.7b": "f2bac04fd889ee85"}
PREFILL_LEN = 4096
# training (phase 12): the reference's peak learning rate; qwen2-1.5b at 4 x
# 1,024 tokens, deepseek-v2 x2 at 1 x 512, 4 steps each
TRAIN_LR = 3e-4
TRAIN_STEPS = 4
TRAIN_SHAPES = {"dense": (4, 1024), "moe": (1, 512)}
# the kernels-vs-plain first two training steps on a 2-layer fp32 cut of
# qwen2-1.5b: loss and grad norm of each within TRAIN_PARITY_TOL of the
# plain run's (relative), each moment leaf within it of its largest entry,
# each param within what those moment errors let the second update move it
# (``_adamw_param_limit``) + one fp32 ulp; and the
# loss and gradients of deepseek-v2 x2 in fp32 with both kernels against
# both plain versions, each gradient leaf within it of its largest entry.
# The kernel forward differs from the plain one by at most 1e-5 of its
# magnitude (LM_KERNEL_TOL), which the backward carries into the gradients
# at that order; 1e-4 leaves 10x.
TRAIN_PARITY_TOL = 1e-4
# GNN training (phase 13): each gradient leaf within GNN_GRAD_TOL x max(1,
# max|g_ref|) of the oracle's, the engines' forward tolerance (MODEL_TOL's
# gcn); losses (relative) and moments (of their leaf's largest entry) of
# two steps within it, params within the sum of both steps'
# _adamw_param_limit at it.  Full width: examples/train_gnn.py's setting
# for real hardware.
GNN_GRAD_TOL = 5e-4
GNN_TRAIN_WIDTH = 8192
GNN_TRAIN_STEPS = 20
WHISPER_DECODER_LEN = 448      # whisper's decoder context (max target positions)
XLSTM_PREFILL_LEN = 1024       # the sLSTM runs one step per token
# Off the path: shapes that reach the tail paths of the COO tile SpMM
# (phase 3) and the grouped FFN (phase 6), held at the same limits.
# COO: tiles per partition (a 0 is a partition with no tile), rows D,
# columns S (37: not a multiple of 4, so the adjacency is read a float a
# lane), width F (20: lanes past the row idle; 130: not a multiple of 4, x
# read a column a lane, in two 128-column slices).
COO_OFF_PATH = [
    dict(case="f20_s37", parts=(3, 0, 2, 4), D=70, S=37, F=20),
    dict(case="f130", parts=(2, 5, 0), D=64, S=584, F=130),
]
# Segment softmax off the path (phase 3), both layouts, on one graph tiled
# 4 x 3: destinations only in the lower half of the vertices (two
# partitions without a tile), a hub row of 3 x 128 + 50 parallel in-edges
# (split into 4 chunks), and in COO every edge into vertex ``dead_row`` and
# ~5 % of the others scored -2e29, below the liveness cut (a row with no
# live edge is 0); widths F 20 (lanes past the row idle) and 130 (not a
# multiple of 4: a column a lane, in 32-column slices).
SOFTMAX_GRAPH = dict(V=400, E=3000, hub=9, hub_edges=3 * 128 + 50, dead_row=20)
SOFTMAX_OFF_PATH = [dict(case="f20", F=20), dict(case="f130", F=130)]
DEAD_SCORE = -2e29
# grouped FFN: d and f multiples of 8 but not of the 32-deep contraction
# step nor of the 128 / 256-column tiles; C past the last full 8-row slice
# (44) and over two row tiles (72); counts mixing 0, C and partial ones
FFN_OFF_PATH = [
    dict(case="tails", C=44, d=200, f=72, counts=(0, 44, 17, 44, 1, 30, 8, 40)),
    dict(case="two_row_tiles", C=72, d=136, f=264, counts=(72, 0, 67, 5)),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event-timed calls."""
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


def bound(n_bytes: float, n_flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    """Least time (ms) on the card, and which term sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / flops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def without_host_sync(fn):
    """Run ``fn`` once with PyTorch's host syncs turned into errors."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


def count_host_syncs(fn):
    """Run ``fn`` once with PyTorch's host syncs turned into warnings;
    return its result and the number of syncs it made."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


def build_timed(fn, times: int = 2):
    """Call ``fn`` (an edge-plan build) ``times`` times, host-timed to a
    synchronize; return the last result, the milliseconds of each call and
    the host syncs of one more call."""
    import torch
    ms = []
    for _ in range(times):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    _, syncs = count_host_syncs(fn)
    return out, ms, syncs


def softmax_off_path_tiles(layout: str):
    """The graph of ``SOFTMAX_GRAPH`` (numpy, seed 0) and its 4 x 3 tiles."""
    import numpy as np
    from repro_torch.core.tiling import grid_tile
    from repro_torch.gnn.graphs import Graph
    c = SOFTMAX_GRAPH
    rng = np.random.default_rng(0)
    src = np.concatenate([rng.integers(0, c["V"], c["E"]),
                          rng.integers(0, c["V"], c["hub_edges"])])
    dst = np.concatenate([rng.integers(0, c["V"] // 2, c["E"]),
                          np.full(c["hub_edges"], c["hub"])])
    g = Graph(src=src.astype(np.int32), dst=dst.astype(np.int32), n_vertices=c["V"])
    return g, grid_tile(g, 4, 3, sparse=True, layout=layout)


def scaled_err(got, ref) -> float:
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the main-path shapes
# ---------------------------------------------------------------------------

def kernel_checks(serve_tiles, csr_tiles, n_vertices, dev):
    import numpy as np
    import torch
    from repro_torch.kernels.tile_spmm import kernel as K
    from repro_torch.kernels.tile_spmm import ops, ref
    from repro_torch.kernels.tile_spmm.plan import coo_plan, csr_plan

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def padded_nan(t, ts):
        """``t`` (T, E, ...) with NaN in every padded edge slot of ``ts``."""
        pad = (torch.arange(t.shape[1], device=dev)[None, :]
               >= torch.as_tensor(ts.n_edge, device=dev)[:, None])
        return t.masked_fill_(pad, float("nan"))

    def plan_of(ts):
        """The edge plan of tiles ``ts`` on the card (as the runner's bind
        builds it), with its build times and host syncs."""
        P, D = ts.n_dst_parts, int(ts.part_size.max())
        pid = torch.as_tensor(ts.part_id, dtype=torch.int32, device=dev)
        if ts.layout == "csr":
            rp = torch.as_tensor(ts.row_ptr, dtype=torch.int32, device=dev)
            return build_timed(lambda: csr_plan(rp, pid, P, ts.e_max))
        ed = torch.as_tensor(ts.edge_dst, dtype=torch.int32, device=dev)
        ne = torch.as_tensor(ts.n_edge, dtype=torch.int32, device=dev)
        return build_timed(lambda: coo_plan(ed, ne, pid, P, D))

    rows = []

    def check(name, kernel, plain, magnitude, n_bytes, n_flops, library=None,
              note=None, primary=True, **extra):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs()
        max_abs = float(err.max())
        ok = bool((err <= KERNEL_TOL[0] + KERNEL_TOL[1] * magnitude()).all())
        require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        require(ok, f"{name}: max abs err {max_abs} over tolerance {KERNEL_TOL}")
        b_ms, b_by = bound(n_bytes, n_flops)
        row = dict(name=name, route="cuda", source=SOURCE,
                   replaces=REPLACES[name], max_abs_err=max_abs,
                   tol_abs=KERNEL_TOL[0], tol_rel=KERNEL_TOL[1],
                   ms=time_ms(kernel), plain_ms=time_ms(plain),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=None if library is None else time_ms(library),
                   shapes=note, **extra)
        emit(dict(phase="kernel_check", **row))
        if primary:
            rows.append(row)
        return got

    # -- COO operands at the serving batch's shapes (phase 4)
    ts = serve_tiles
    T, S, E, P = ts.n_tiles, ts.s_max, ts.e_max, ts.n_dst_parts
    D = int(ts.part_size.max())
    n_edge = int(ts.n_edge.sum())
    n_src = int(ts.n_src.sum())
    part_id = torch.as_tensor(ts.part_id, dtype=torch.int32, device=dev)
    part_ptr = torch.as_tensor(K.partition_ptr(ts.part_id, P), device=dev)
    flags = torch.as_tensor(K.tile_flags(ts.part_id), device=dev)
    edge_dst = torch.as_tensor(ts.edge_dst, device=dev).long()
    edge_src = torch.as_tensor(ts.edge_src, device=dev).long()
    n_edge_t = torch.as_tensor(ts.n_edge, device=dev).long()
    adj = ops.densify_edge_weights(randn(T, E), edge_dst, edge_src, n_edge_t,
                                   dmax=D, smax=S)
    xsrc = randn(T, S, WIDTH)
    out_bytes = P * D * WIDTH * 4

    def coo_spmm():
        return K.tile_spmm_cuda(adj, xsrc, part_id, flags, n_parts=P,
                                part_ptr=part_ptr)

    without_host_sync(coo_spmm)
    check("tile_spmm", coo_spmm,
          lambda: ref.tile_spmm_ref(adj, xsrc, part_id, P),
          lambda: ref.tile_spmm_ref(adj.abs(), xsrc.abs(), part_id, P),
          adj.numel() * 4 + n_src * WIDTH * 4 + T * 4 + out_bytes,
          2 * WIDTH * n_edge,
          library=lambda: torch.bmm(adj, xsrc),
          note=dict(T=T, D=D, S=S, F=WIDTH, P=P, edges=n_edge,
                    library="torch.bmm(adj, xsrc): the per-tile product "
                            "without the partition sum"))

    # the COO SpMM off the path (COO_OFF_PATH): ~0.5 % of the adjacency
    # nonzero, as on the path
    for c in COO_OFF_PATH:
        Tc, Dc, Sc, Fc = sum(c["parts"]), c["D"], c["S"], c["F"]
        Pc = len(c["parts"])
        pid_np = np.repeat(np.arange(Pc, dtype=np.int32), c["parts"])
        pid = torch.as_tensor(pid_np, device=dev)
        ptr = torch.as_tensor(K.partition_ptr(pid_np, Pc), device=dev)
        a = randn(Tc, Dc, Sc) * (torch.rand((Tc, Dc, Sc), generator=gen, device=dev) < 0.005)
        xc = randn(Tc, Sc, Fc)
        fl = torch.as_tensor(K.tile_flags(pid_np), device=dev)
        edges = int((a != 0).sum())
        check("tile_spmm",
              lambda: K.tile_spmm_cuda(a, xc, pid, fl, n_parts=Pc, part_ptr=ptr),
              lambda: ref.tile_spmm_ref(a, xc, pid, Pc),
              lambda: ref.tile_spmm_ref(a.abs(), xc.abs(), pid, Pc),
              a.numel() * 4 + xc.numel() * 4 + Tc * 4 + Pc * Dc * Fc * 4,
              2 * Fc * edges, library=lambda: torch.bmm(a, xc),
              note=dict(T=Tc, D=Dc, S=Sc, F=Fc, P=Pc, edges=edges,
                        tiles_per_partition=list(c["parts"])),
              primary=False, case=c["case"])
        del a, xc

    del adj, xsrc

    def softmax(name, ts, s_e, xsrc, built, primary=True, case=None,
                col=None, src_rows=None):
        """One segment softmax on tiles ``ts``: per-edge scores ``s_e``
        (T, E), the source operand ``xsrc`` and the columns ``col`` that
        index it (the replica (T, S, F) and the tiles' own columns unless
        given: the flat store and global columns, reading ``src_rows``
        distinct rows), walking the plan ``built`` (plan, build ms, host
        syncs) against the plan walk's plain version.  Returns the kernel's
        output."""
        plan, plan_ms, plan_syncs = built
        coo = ts.layout == "coo"
        T, E = s_e.shape
        x_rows, S = ref._source_rows(xsrc, T)
        F = x_rows.shape[1]
        P, D = ts.n_dst_parts, int(ts.part_size.max())
        pid = torch.as_tensor(ts.part_id, dtype=torch.int32, device=dev)
        fl = torch.as_tensor(K.tile_flags(ts.part_id), device=dev)
        if col is None:
            col = torch.as_tensor(ts.edge_src, dtype=torch.int32, device=dev)
        if src_rows is None:
            src_rows = int(ts.n_src.sum())
        if coo:
            ed = torch.as_tensor(ts.edge_dst, dtype=torch.int32, device=dev)
            ne = torch.as_tensor(ts.n_edge, dtype=torch.int32, device=dev)

            def kernel():
                return K.segment_softmax_cuda(ed, ne, col, s_e, xsrc, pid, fl,
                                              n_parts=P, dmax=D, plan=plan)
        else:
            rp = torch.as_tensor(ts.row_ptr, dtype=torch.int32, device=dev)

            def kernel():
                return K.segment_softmax_csr_cuda(rp, col, s_e, xsrc, pid, fl,
                                                  n_parts=P, plan=plan)
        n_edge = plan.slot.numel()
        chunks = plan.split_ptr.diff()
        note = dict(T=T, D=D, S=ts.s_max, E=E, F=F, P=P, layout=ts.layout,
                    form="replica" if S else "flat", src_rows=src_rows,
                    edges=n_edge, groups=plan.group_ptr.numel() - 1,
                    zero_rows=plan.zero_row.numel(),
                    split_rows=plan.split_row.numel(),
                    most_chunks=int(chunks.max()) if chunks.numel() else 1,
                    partials=plan.n_partial, chunk_size=plan.chunk_size)
        library = None
        extra = {}
        if primary:
            without_host_sync(kernel)
            # the library yardstick, two calls: torch.sparse.softmax over
            # the (P*D, live edges) score matrix, then torch.sparse.mm with
            # the edges' source rows (the matrix and the rows are built here,
            # outside the timing)
            slot = plan.slot.long()
            s = s_e.reshape(-1)[slot]
            keep = torch.nonzero(s > ref._LIVE if coo else torch.isfinite(s)).flatten()
            rows_of = torch.repeat_interleave(
                torch.arange(P * D, device=dev), plan.row_start.diff().long())
            sp = torch.sparse_coo_tensor(
                torch.stack([rows_of[keep], torch.arange(keep.numel(), device=dev)]),
                s[keep], (P * D, keep.numel())).coalesce()
            vals = x_rows[(slot[keep] // E) * S
                          + col.reshape(-1).long()[slot[keep]]]

            def library():
                return torch.sparse.mm(torch.sparse.softmax(sp, 1), vals)

            extra = dict(library_max_abs_diff=float(
                (library().view(P, D, F) - kernel()).abs().max()))
            note["library"] = ("two calls: torch.sparse.softmax over the "
                               "(P*D, edges) score matrix, then torch.sparse.mm "
                               "with the edges' gathered source rows")
        return check(
            name, kernel,
            lambda: ref.segment_softmax_plan_ref(plan, col, s_e, xsrc, P, coo=coo),
            lambda: ref.segment_softmax_plan_ref(plan, col, s_e, xsrc.abs(), P,
                                                 coo=coo),
            plan.nbytes + n_edge * 8 + src_rows * F * 4 + P * D * F * 4
            + plan.n_partial * (F + 2) * 4,
            n_edge * (2 * F + 3), library=library, note=note,
            primary=primary, case=case, plan_first_ms=plan_ms[0],
            plan_ms=plan_ms[-1], plan_host_syncs=plan_syncs,
            plan_bytes=plan.nbytes, **extra)

    # the softmaxes off the path (SOFTMAX_OFF_PATH), both layouts
    for layout in ("coo", "csr"):
        g, tc = softmax_off_path_tiles(layout)
        built = plan_of(tc)
        dst_of = torch.as_tensor(g.dst, device=dev)[
            torch.as_tensor(tc.edge_gid, device=dev).long()]
        for c in SOFTMAX_OFF_PATH:
            s_c = padded_nan(randn(tc.n_tiles, tc.e_max), tc)
            if layout == "coo":
                dead = ((dst_of == SOFTMAX_GRAPH["dead_row"])
                        | (torch.rand(s_c.shape, generator=gen, device=dev) < 0.05))
                s_c = torch.where(dead & ~torch.isnan(s_c), DEAD_SCORE, s_c)
            softmax("segment_softmax" if layout == "coo" else "segment_softmax_csr",
                    tc, s_c, randn(tc.n_tiles, tc.s_max, c["F"]), built,
                    primary=False, case=f"{c['case']}_{layout}")

    # the COO softmax at the serving batch's shapes
    softmax("segment_softmax", ts, padded_nan(randn(T, E), ts),
            randn(T, S, WIDTH), plan_of(ts))

    # -- CSR operands at the whole-graph phase's shapes (phase 5), first in
    # the form the whole-graph pass hands the kernels: the flat (V, F) store
    # read through global columns gcol = src_ids[t, edge_src[t, e]]; then,
    # as a second case, the (T, S, F) replica of its rows through tile-local
    # columns, which must give the same bits.  Padded edge slots and every
    # store row that no edge names hold NaN, which the kernels must never read
    ts = csr_tiles
    T, S, E, P = ts.n_tiles, ts.s_max, ts.e_max, ts.n_dst_parts
    D = int(ts.part_size.max())
    n_edge = int(ts.n_edge.sum())
    n_src = int(ts.n_src.sum())
    part_id = torch.as_tensor(ts.part_id, dtype=torch.int32, device=dev)
    flags = torch.as_tensor(K.tile_flags(ts.part_id), device=dev)
    row_ptr = torch.as_tensor(ts.row_ptr, dtype=torch.int32, device=dev)
    col = torch.as_tensor(ts.edge_src, dtype=torch.int32, device=dev)
    src_ids = torch.as_tensor(ts.src_ids, device=dev).long()
    gcol = src_ids.gather(1, col.long()).to(torch.int32)
    t_e, slot, dest = ref._csr_edges(row_ptr, part_id, E)
    named = torch.zeros(n_vertices, dtype=torch.bool, device=dev)
    named[gcol[t_e, slot].long()] = True
    n_named = int(named.sum())
    store = randn(n_vertices, WIDTH).masked_fill_(~named[:, None], float("nan"))
    xsrc = store[src_ids]
    w = padded_nan(randn(T, E), ts)
    out_bytes = P * D * WIDTH * 4
    # the library yardstick: one sparse (P*D, V) CSR product over the store,
    # built here from the same edges (only the product is timed)
    sp = torch.sparse_coo_tensor(
        torch.stack([dest, gcol[t_e, slot].long()]), w[t_e, slot],
        (P * D, n_vertices)).coalesce().to_sparse_csr()
    # the edge plan, built once per tile set (as PipelinedRunner.bind does):
    # the first build in the process, and a second one
    built = plan_of(ts)
    plan, plan_ms, plan_syncs = built
    # each form's columns, operand and source rows read (the flat store's
    # distinct named rows, as the benchmark's roofline counts them; the
    # replica's real slots)
    forms = (("flat", gcol, store, n_named), ("replica", col, xsrc, n_src))
    spmm_out = {}
    for form, c, x, src_rows in forms:
        flat = form == "flat"

        def csr_spmm():
            return K.tile_spmm_csr_cuda(row_ptr, c, w, x, part_id, flags,
                                        n_parts=P, plan=plan)

        if flat:
            without_host_sync(csr_spmm)
        spmm_out[form] = check(
            "tile_spmm_csr", csr_spmm,
            lambda: ref.tile_spmm_csr_ref(row_ptr, c, w, x, part_id, P),
            lambda: ref.tile_spmm_csr_ref(row_ptr, c, w.abs(), x.abs(),
                                          part_id, P),
            plan.nbytes + n_edge * 8 + src_rows * WIDTH * 4 + out_bytes,
            2 * WIDTH * n_edge,
            library=(lambda: torch.sparse.mm(sp, store)) if flat else None,
            note=dict(T=T, D=D, S=S, E=E, F=WIDTH, P=P, V=n_vertices,
                      form=form, src_rows=src_rows, edges=n_edge,
                      groups=plan.group_ptr.shape[0] - 1,
                      zero_rows=plan.zero_row.shape[0],
                      split_rows=plan.split_row.shape[0],
                      partials=plan.n_partial, chunk_size=plan.chunk_size,
                      library="torch.sparse.mm of the (P*D, V) CSR matrix "
                              "of the same edges with the store" if flat
                      else None),
            primary=flat, case=form, plan_first_ms=plan_ms[0],
            plan_ms=plan_ms[1], plan_host_syncs=plan_syncs,
            plan_bytes=plan.nbytes)
    require(torch.equal(spmm_out["flat"], spmm_out["replica"]),
            "tile_spmm_csr: the flat store's output differs from the replica's")
    del sp, w, spmm_out

    # the CSR softmax on the same tiles, plan and operands
    s_e = padded_nan(randn(T, E), ts)
    soft_out = {form: softmax("segment_softmax_csr", ts, s_e, x, built,
                              primary=form == "flat", case=form, col=c,
                              src_rows=src_rows)
                for form, c, x, src_rows in forms}
    require(torch.equal(soft_out["flat"], soft_out["replica"]),
            "segment_softmax_csr: the flat store's output differs from the "
            "replica's")
    del xsrc, store, forms, soft_out, plan, built
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def serving_phase(graphs, dev):
    import numpy as np
    import torch
    from repro_torch.core import compiler
    from repro_torch.core.executor import run_reference
    from repro_torch.gnn import graphs as G
    from repro_torch.gnn import models as M
    from repro_torch.kernels.tile_spmm.kernel import LAUNCHES
    from repro_torch.kernels.tile_spmm.plan import coo_plan
    from repro_torch.serve import InferenceServer, ShapeRegistry

    # the host half of every submit: merge the batch and tile it onto the
    # class's canonical shapes (the server repeats this per request)
    t0 = time.perf_counter()
    batch = G.batch_graphs(graphs)
    _, tiles, _, _ = ShapeRegistry().canonical("shapes", batch.graph)
    host_tiling_s = time.perf_counter() - t0
    # the COO edge plan a gat submit builds at bind, from the tiles' arrays
    # on the card: three builds, and the host syncs of one
    pid = torch.as_tensor(tiles.part_id, dtype=torch.int32, device=dev)
    ed = torch.as_tensor(tiles.edge_dst, dtype=torch.int32, device=dev)
    ne = torch.as_tensor(tiles.n_edge, dtype=torch.int32, device=dev)
    _, plan_ms, plan_syncs = build_timed(
        lambda: coo_plan(ed, ne, pid, tiles.n_dst_parts, int(tiles.part_size.max())),
        times=3)
    expect = {"gcn": "tile_spmm", "gat": "segment_softmax"}
    for name in ("gcn", "gat"):
        tr = M.trace_stacked(name, 2, WIDTH, WIDTH, WIDTH)
        params = M.init_params(tr, seed=0)
        inputs = [M.init_inputs(tr, g, seed=i) for i, g in enumerate(graphs)]
        before = LAUNCHES[expect[name]]
        torch.cuda.reset_peak_memory_stats()
        server = InferenceServer(compiler.compile_gnn(tr), params, device=dev)
        lat = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = server.submit(graphs, inputs)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        require(server.compile_count == 1 and server.cache_hits == 2,
                f"serving {name}: builds={server.compile_count} "
                f"hits={server.cache_hits}, expected 1 build then 2 hits")
        require(LAUNCHES[expect[name]] > before,
                f"serving {name}: kernel {expect[name]} never launched")
        got = torch.cat([o[0] for o in outs])
        merged = {k: np.concatenate([inp[k] for inp in inputs])
                  for k in inputs[0]}
        want = run_reference(tr, batch.graph, merged, params, device=dev)[0]
        require(got.shape == (batch.graph.n_vertices, WIDTH)
                and bool(torch.isfinite(got).all()),
                f"serving {name}: output shape {tuple(got.shape)} or non-finite")
        err = scaled_err(got, want)
        require(err <= MODEL_TOL[name],
                f"serving {name}: err {err} over {MODEL_TOL[name]}")
        warm = lat[1:]
        plan = (dict(softmax_plan_ms=plan_ms, softmax_plan_host_syncs=plan_syncs)
                if name == "gat" else {})
        emit(dict(phase="serving", model=f"{name}_x2", layout="coo",
                  graphs=len(graphs), vertices=batch.graph.n_vertices,
                  edges=batch.graph.n_edges, cold_s=lat[0],
                  warm_p50_s=statistics.median(warm),
                  graphs_per_s=len(graphs) / statistics.median(warm),
                  host_tiling_s=host_tiling_s,
                  builds=server.compile_count, hits=server.cache_hits,
                  err_vs_oracle=err, tol=MODEL_TOL[name],
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **plan))


def whole_graph_phase(graph, tiles, dev):
    import torch
    from repro_torch.core import compiler
    from repro_torch.core.executor import run_reference
    from repro_torch.core.pipeline import run_pipelined
    from repro_torch.gnn import models as M
    from repro_torch.kernels.tile_spmm.kernel import LAUNCHES

    expect = {"gcn": "tile_spmm_csr", "gat": "segment_softmax_csr"}
    for name in ("gcn", "gat"):
        tr = M.trace_stacked(name, 2, WIDTH, WIDTH, WIDTH)
        params = M.init_params(tr, seed=0)
        inputs = M.init_inputs(tr, graph, seed=0)
        before = LAUNCHES[expect[name]]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run_pipelined(compiler.compile_gnn(tr), graph, tiles, inputs,
                            params, device=dev)[0]
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        require(LAUNCHES[expect[name]] > before,
                f"whole graph {name}: kernel {expect[name]} never launched")
        want = run_reference(tr, graph, inputs, params, device=dev)[0]
        require(got.shape == (graph.n_vertices, WIDTH)
                and bool(torch.isfinite(got).all()),
                f"whole graph {name}: output shape {tuple(got.shape)} or non-finite")
        err = scaled_err(got, want)
        require(err <= MODEL_TOL[name],
                f"whole graph {name}: err {err} over {MODEL_TOL[name]}")
        emit(dict(phase="whole_graph", model=f"{name}_x2", layout="csr",
                  graph=graph.name, vertices=graph.n_vertices,
                  edges=graph.n_edges, run_s=run_s, err_vs_oracle=err,
                  tol=MODEL_TOL[name],
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))


# ---------------------------------------------------------------------------
# phase 5b: R-GCN as published: the relation GEMM, its backward, the runner
# ---------------------------------------------------------------------------

def _gamma(n: int) -> float:
    """gamma_n = n u / (1 - n u), u = 2^-24: two float32 sums of n terms in
    any two orders differ by at most 2 gamma_n times the sum of |terms|."""
    nu = n * 2.0 ** -24
    return nu / (1 - nu) if nu < 1 else float("inf")


class _plain_relation_gemm:
    """Within it, the relation GEMM and its backward take their plain
    versions on every device (``ops._gemm`` / ``ops._wgrad`` swapped)."""

    def __init__(self, rops):
        self.rops = rops

    def __enter__(self):
        r = self.rops
        self.saved = r._gemm, r._wgrad
        r._gemm = lambda x, w, plan, out=None: r.relation_gemm_ref(x, w, plan, out)
        r._wgrad = r.relation_wgrad_ref

    def __exit__(self, *exc):
        self.rops._gemm, self.rops._wgrad = self.saved


def relational_phase(graph, dev, *, width=WIDTH, grid=64, rgcn=RGCN):
    """Phase 5b on ``graph`` (the canonical edges); returns the relation
    GEMM's ``kernels`` row and its launches in the runner's pass."""
    import numpy as np
    import torch
    from repro_torch.core import compiler
    from repro_torch.core.executor import run_reference
    from repro_torch.core.pipeline import PipelinedRunner
    from repro_torch.core.tiling import build_tiles
    from repro_torch.gnn import relational as RL
    from repro_torch.kernels.relation_gemm import kernel as RK
    from repro_torch.kernels.relation_gemm import ops as rops

    R, F = rgcn["relations"], width
    law = 1.0 / np.arange(1, R // 2 + 1) ** rgcn["zipf"]
    rel = np.random.default_rng(rgcn["relation_seed"]).choice(
        R // 2, size=graph.n_edges, p=law / law.sum()).astype(np.int32)
    t0 = time.perf_counter()
    g, einp = RL.relational_graph(graph.src, graph.dst, rel, graph.n_vertices, R,
                                  name=graph.name)
    tiles, ro = build_tiles(g, grid, grid, layout="csr")
    host_s = time.perf_counter() - t0
    E, V = g.n_edges, g.n_vertices
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # the kernel, each edge reading its source row of the (V, F) table
    types = torch.as_tensor(g.edge_type, device=dev)
    plan = rops.read_rows(rops.relation_plan(types, R),
                          torch.as_tensor(g.src, device=dev))
    x, w = randn(V, F), randn(R, F, F, scale=F ** -0.5)
    sizes = torch.bincount(types.long(), minlength=R)

    def kernel():
        return rops.relation_gemm(x, w, plan)

    def plain():
        return rops.relation_gemm_ref(x, w, plan)

    without_host_sync(kernel)
    got, want = kernel(), plain()
    err = (got - want).abs()
    # each output is a float32 dot product of F terms
    ok = bool((err <= 2 * _gamma(F) * rops.relation_gemm_ref(x.abs(), w.abs(), plan)).all())
    require(bool(torch.isfinite(got).all()), "relation_gemm: non-finite output")
    require(ok, f"relation_gemm: max abs err {float(err.max())} over 2 gamma_F sum|x w|")
    b_ms, b_by = bound(E * 2 * F * 4 + E * 8 + R * F * F * 4, 2 * E * F * F)
    row = dict(name="relation_gemm", route="cuda", source=RELATION_SOURCE,
               replaces=REPLACES["relation_gemm"], max_abs_err=float(err.max()),
               tol="2 gamma_F sum|x w|, elementwise", ms=time_ms(kernel),
               plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by, library_ms=None,
               shapes=dict(E=E, R=R, F=F, table=V, largest_relation=int(sizes.max()),
                           smallest_relation=int(sizes.min()),
                           tiles=int(plan.tile_off[-1])))
    emit(dict(phase="kernel_check", **row))
    del got, want, err

    # its backward: dx through the same kernel (W transposed, rows swapped,
    # added atomically into the table's rows), dW through the weight-gradient
    # kernel, against the plain versions
    xg, wg, dy = x.clone().requires_grad_(), w.clone().requires_grad_(), randn(E, F)

    def backward():
        return torch.autograd.grad(rops.relation_gemm(xg, wg, plan), (xg, wg), dy)

    n0 = dict(RK.LAUNCHES)
    dx, dw = without_host_sync(backward)
    require(RK.LAUNCHES["relation_gemm"] - n0["relation_gemm"] == 2
            and RK.LAUNCHES["relation_wgrad"] - n0["relation_wgrad"] == 1,
            f"relation GEMM backward: launches {RK.LAUNCHES} from {n0}")
    back = rops.RelationPlan(plan.dst_rows, plan.src_rows, plan.seg, plan.tile_off)
    wt = w.transpose(1, 2)
    uses = int(torch.bincount(plan.src_rows.long(), minlength=V).max())
    bwd = {}
    for name, got, want, mag, n in (
            ("dx", dx, rops.relation_gemm_ref(dy, wt, back, out=torch.zeros_like(x)),
             rops.relation_gemm_ref(dy.abs(), wt.abs(), back, out=torch.zeros_like(x)),
             F * uses),
            ("dw", dw, rops.relation_wgrad_ref(x, dy, plan),
             rops.relation_wgrad_ref(x.abs(), dy.abs(), plan), int(sizes.max()))):
        err = (got - want).abs()
        rel_max = float(err.max()) / float(want.abs().max())
        bwd[name] = dict(max_abs_err=float(err.max()), err_of_max=rel_max, terms=n,
                         limit_of_max=n ** 0.5 * 2.0 ** -24)
        require(bool(torch.isfinite(got).all()), f"relation GEMM {name}: non-finite")
        # 2 gamma_n bounds rounding errors that all align, loose for long
        # sums; at random they add to ~sqrt(n) u of the largest entry, which
        # a wrong row or relation passes by orders of magnitude
        require(bool((err <= 2 * _gamma(n) * mag).all())
                and rel_max <= bwd[name]["limit_of_max"],
                f"relation GEMM {name}: {bwd[name]}")
    emit(dict(phase="relation_gemm_backward", **bwd, ms=time_ms(backward),
              bound_ms=2 * b_ms))
    del dx, dw, xg, wg, dy, x, w, plan

    # one pass of the runner, and the gradients of a probe through it
    tr = RL.trace_rgcn(2, F, F, F, R)
    shapes = RL.basis_shapes(2, F, F, F, R, rgcn["bases"])
    params = {k: randn(*s, scale=s[-2] ** -0.5) for k, s in shapes.items()}
    inputs = {k: torch.as_tensor(v, device=dev) for k, v in einp.items()}
    inputs["x"] = randn(V, F)
    runner = PipelinedRunner(compiler.compile_gnn(tr), ro.graph, tiles,
                             reordering=ro, device=dev)
    with torch.inference_mode():
        RL.run(runner, inputs, params)                       # binds
        torch.cuda.synchronize()
        RK.reset_launches()
        out = RL.run(runner, inputs, params)[0]
        torch.cuda.synchronize()
        launches = dict(RK.LAUNCHES)
        pass_ms = time_ms(lambda: RL.run(runner, inputs, params), runs=10)
    require(launches == {"relation_gemm": 2, "relation_wgrad": 0},
            f"R-GCN pass: relation GEMM launches {launches}, expected one a layer")
    want = run_reference(tr, g, inputs, RL.combine_bases(params), device=dev)[0]
    fwd_err = scaled_err(out, want)
    require(bool(torch.isfinite(out).all()) and fwd_err <= MODEL_TOL["rgcn"],
            f"R-GCN pass: err {fwd_err} over {MODEL_TOL['rgcn']}")
    del out, want
    probe = randn(V, F)
    leaves = {"x": inputs["x"], **params}

    def grads(run, dtype=torch.float32):
        p = {k: v.detach().to(dtype).requires_grad_() for k, v in leaves.items()}
        i = {k: v.to(dtype) for k, v in inputs.items()}
        i["x"] = p.pop("x")
        y = run(i, p)
        got = torch.autograd.grad((y * probe.to(dtype)).sum(), [i["x"], *p.values()])
        return {k: v.double() for k, v in zip(leaves, got)}

    RK.reset_launches()
    kernels = grads(lambda i, p: RL.run(runner, i, p)[0])
    grad_launches = dict(RK.LAUNCHES)
    with _plain_relation_gemm(rops):
        plain_grads = grads(lambda i, p: RL.run(runner, i, p)[0])
    oracle = {dt: grads(lambda i, p: run_reference(tr, g, i, RL.combine_bases(p),
                                                   device=dev)[0], dt)
              for dt in (torch.float32, torch.float64)}
    exact = oracle[torch.float64]

    def err(got):
        return {k: float((got[k] - w).abs().max() / w.abs().max()) for k, w in exact.items()}

    # Against the fp64 oracle, float32 gradients here are off by 1e-3-1e-2
    # of their largest entry, the fp32 oracle's as much: ReLUs whose
    # pre-activation lies within rounding of 0 take the other branch in one
    # run and not the other.  So the kernels are held to the plain versions
    # in the same runner, each against fp64: a wrong row or relation moves
    # a leaf by the order of its largest entry, far past GRAD_PLAIN_MULTIPLE
    # times the plain versions' own error.
    e_kernel, e_plain, e_oracle = err(kernels), err(plain_grads), err(oracle[torch.float32])
    emit(dict(phase="rgcn", graph=g.name, vertices=V, messages=E, relations=R,
              bases=rgcn["bases"], width=F, host_graph_and_tiling_s=host_s,
              tiles=tiles.n_tiles, s_max=tiles.s_max, pass_ms=pass_ms,
              launches=launches, err_vs_oracle=fwd_err, tol=MODEL_TOL["rgcn"],
              grad_launches=grad_launches, grad_err_vs_fp64=e_kernel,
              plain_grad_err_vs_fp64=e_plain, oracle_grad_err_vs_fp64=e_oracle,
              grad_plain_multiple=GRAD_PLAIN_MULTIPLE,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
    require(grad_launches == {"relation_gemm": 4, "relation_wgrad": 2},
            f"R-GCN gradients: relation GEMM launches {grad_launches}")
    for k, e in e_kernel.items():
        require(e <= GRAD_PLAIN_MULTIPLE * e_plain[k] + 1e-6,
                f"R-GCN gradient {k}: {e} of its largest entry from fp64, the plain "
                f"versions' {e_plain[k]}")
    return row, launches["relation_gemm"]


# ---------------------------------------------------------------------------
# phase 6: the LM kernels against their plain versions at phase 7's shapes
# ---------------------------------------------------------------------------

def _flash_keep(B, Sq, Sk, causal, window, kv_len, dev):
    """(B, Sq, Sk) bool: the (query, key) pairs the masks keep, queries
    right-aligned against the keys."""
    import torch
    from repro_torch.kernels.flash_attention.ref import block_mask
    lens = torch.full((B,), Sk, device=dev) if kv_len is None else kv_len.long()
    return block_mask(Sq, Sk, 0, Sk, causal, window, lens, dev)


def lm_kernel_checks(cfgs, dev, *, prefill_len=PREFILL_LEN, cache_len=40,
                     decode_batch=4, runs=5):
    """``cfgs``: the configs phase 7 serves, by family (dense, moe, vlm,
    audio, hybrid; ssm runs no kernel)."""
    import dataclasses

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.moe_dispatch import kernel as GK
    from repro_torch.kernels.moe_dispatch import ops as moe_ops
    from repro_torch.kernels.moe_dispatch.ref import grouped_ffn_magnitude, grouped_ffn_ref
    from repro_torch.models.lm import VLM_PATCHES
    from repro_torch.models.moe import capacity

    dense_cfg, moe_cfg = cfgs["dense"], cfgs["moe"]
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    rows, failed = [], []

    def check(name, case, dtype, kernel, plain, magnitude, n_bytes, n_flops,
              library, library_label, shapes, primary):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        err = (got - want).abs()
        tol = LM_KERNEL_TOL[name]
        limit = tol[0] + tol[1] * magnitude().float()
        if dtype == "bfloat16":
            limit += BF16_ULP * want.abs()
        max_abs = float(err.max())
        worst = float((err / limit).max())       # <= 1 where the check holds
        if not bool(torch.isfinite(got).all()):
            failed.append(f"{name} {case} {dtype}: non-finite output")
        elif worst > 1:
            failed.append(f"{name} {case} {dtype}: max abs err {max_abs}, "
                          f"{worst:.3g} x its elementwise limit")
        del got, want, err, limit
        rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else FP32_FLOPS_PER_S
        b_ms, b_by = bound(n_bytes, n_flops, rate)
        row = dict(name=name, case=case, dtype=dtype, route="cuda",
                   source=LM_SOURCES[name], replaces=REPLACES[name],
                   max_abs_err=max_abs, err_over_limit=worst, tol_abs=tol[0],
                   tol_rel=tol[1], tol_ulp=BF16_ULP if dtype == "bfloat16" else 0.0,
                   ms=time_ms(kernel, runs, 1), plain_ms=time_ms(plain, runs, 1),
                   bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library, runs, 1),
                   library=library_label, shapes=shapes, primary=primary)
        emit(dict(phase="lm_kernel_check", **row))
        rows.append(row)
        torch.cuda.empty_cache()

    # -- flash attention: MLA prefill, GQA prefill, GQA decode (the path's
    # shapes), and two cases off the path: a prompt whose length fits
    # neither the 128-row query tile nor the 64-key tile, and the options
    # the path does not use (head dim 256, a sliding window, a partial last
    # query tile, kv_len)
    m = moe_cfg.mla
    decode_lens = [cache_len - (cache_len * i) // (2 * decode_batch)
                   for i in range(decode_batch)]
    flash_cases = [
        ("mla_prefill", 1, prefill_len, prefill_len, moe_cfg.n_heads, moe_cfg.n_heads,
         m.qk_nope + m.qk_rope, m.v_dim, True, None, None),
        ("gqa_prefill", 1, prefill_len, prefill_len, dense_cfg.n_heads,
         dense_cfg.n_kv_heads, dense_cfg.hdim, dense_cfg.hdim, True, None, None),
        ("gqa_decode", decode_batch, 1, cache_len, dense_cfg.n_heads,
         dense_cfg.n_kv_heads, dense_cfg.hdim, dense_cfg.hdim, False, None, decode_lens),
        ("gqa_ragged", 1, 1000, 1000, dense_cfg.n_heads, dense_cfg.n_kv_heads,
         dense_cfg.hdim, dense_cfg.hdim, True, None, None),
        ("window_d256", 2, 65, 130, 4, 2, 256, 256, True, 30, [110, 130]),
    ]
    # the other families' shapes (phase 7): the vlm prefill (256 patches +
    # the prompt, 64 / 8 heads); whisper's encoder (1,500 frames, not
    # causal), its decoder's cross-attention (448 queries against the 1,500
    # encoder keys) and a decode step's (no kv_len); zamba2's shared block
    # (head dim 80, window 4,096) at prefill and as a decode step on its
    # ring cache (kv_len)
    vlm, audio, hyb = cfgs["vlm"], cfgs["audio"], cfgs["hybrid"]
    flash_cases += [
        ("vlm_prefill", 1, VLM_PATCHES + prefill_len, VLM_PATCHES + prefill_len,
         vlm.n_heads, vlm.n_kv_heads, vlm.hdim, vlm.hdim, True, None, None),
        ("whisper_encoder", 1, audio.enc_len, audio.enc_len, audio.n_heads,
         audio.n_kv_heads, audio.hdim, audio.hdim, False, None, None),
        ("whisper_cross", 1, WHISPER_DECODER_LEN, audio.enc_len, audio.n_heads,
         audio.n_kv_heads, audio.hdim, audio.hdim, False, None, None),
        ("whisper_cross_decode", decode_batch, 1, audio.enc_len, audio.n_heads,
         audio.n_kv_heads, audio.hdim, audio.hdim, False, None, None),
        ("zamba_prefill", 1, prefill_len, prefill_len, hyb.n_heads, hyb.n_kv_heads,
         hyb.hdim, hyb.hdim, True, hyb.attn_window, None),
        ("zamba_ring_decode", decode_batch, 1, cache_len, hyb.n_heads, hyb.n_kv_heads,
         hyb.hdim, hyb.hdim, False, hyb.attn_window, decode_lens),
    ]
    for case, B, Sq, Sk, H, K, D, Dv, causal, window, kv_list in flash_cases:
        q32, k32, v32 = randn(B, Sq, H, D), randn(B, Sk, K, D), randn(B, Sk, K, Dv)
        kv_len = (None if kv_list is None
                  else torch.tensor(kv_list, dtype=torch.int32, device=dev))
        keep = _flash_keep(B, Sq, Sk, causal, window, kv_len, dev)
        # every query row keeps a key: a row with none is 0 from the kernel
        # (as from the Pallas kernel) and the masked rows' mean from the
        # plain version (as from the scan path)
        require(bool(keep.any(-1).all()), f"flash {case}: a query row keeps no key")
        pairs = int(keep.sum())
        kv_rows = B * Sk if kv_list is None else sum(min(Sk, n) for n in kv_list)
        # the library yardstick: SDPA on (B, H, S, D), K/V heads repeated to
        # H and the layout change made outside the timing; a boolean mask
        # wherever is_causal cannot say it
        mask = None if window is None and kv_len is None else keep[:, None]
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            q, k, v = q32.to(tdt), k32.to(tdt), v32.to(tdt)
            v_abs = v.abs()
            el = q.element_size()
            n_bytes = el * (q.numel() + kv_rows * K * (D + Dv) + B * Sq * H * Dv) + \
                (0 if kv_len is None else 4 * B)
            qt = q.transpose(1, 2).contiguous()
            kt = k.transpose(1, 2).repeat_interleave(H // K, dim=1).contiguous()
            vt = v.transpose(1, 2).repeat_interleave(H // K, dim=1).contiguous()
            opts = dict(causal=causal, window=window, kv_len=kv_len)
            if case == "gqa_prefill" and dtype == "float32":
                without_host_sync(lambda: FK.flash_attention_cuda(q, k, v, **opts))
            check("flash_attention", case, dtype,
                  lambda: FK.flash_attention_cuda(q, k, v, **opts),
                  lambda: flash_attention_ref(q, k, v, **opts),
                  lambda: flash_attention_ref(q, k, v_abs, **opts),
                  n_bytes, pairs * H * (2 * D + 2 * Dv),
                  library=lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None),
                  library_label="torch.nn.functional.scaled_dot_product_attention "
                                "(K/V repeated to H heads)",
                  shapes=dict(B=B, Sq=Sq, Sk=Sk, H=H, K=K, D=D, Dv=Dv, causal=causal,
                              window=window, kv_len=kv_list, pairs_per_head=pairs),
                  primary=(case == "mla_prefill" and dtype == "float32"))
            del q, k, v, v_abs, qt, kt, vt
        del q32, k32, v32, keep, mask

    # -- grouped FFN: a prefill chunk's buckets and a decode step's, with the
    # live counts of a real top-k routing
    mo = moe_cfg.moe
    E, d, f = mo.n_routed, moe_cfg.d_model, mo.d_ff_expert
    w32 = dict(wg=randn(E, d, f, scale=d ** -0.5), wu=randn(E, d, f, scale=d ** -0.5),
               wd=randn(E, f, d, scale=f ** -0.5))
    router = randn(d, E, scale=d ** -0.5)
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        w = {k_: t.to(tdt) for k_, t in w32.items()}
        el = torch.finfo(tdt).bits // 8
        for case, n_tok in (("prefill_chunk", prefill_len // 4), ("decode", decode_batch)):
            cap = capacity(moe_cfg, n_tok)
            x = randn(n_tok, d)
            r = moe_ops.route(x, router, mo.top_k, cap, norm_topk=mo.norm_topk)
            buckets = moe_ops.dispatch(x, r, E, cap).to(tdt)
            counts = torch.clamp(r.counts, max=cap).to(torch.int32)
            live_rows = int(counts.sum())
            live_experts = int((counts > 0).sum())
            n_bytes = el * (live_experts * 3 * d * f + live_rows * d + E * cap * d) + 4 * E
            args = (buckets, w["wg"], w["wu"], w["wd"], counts)
            cfg = GK.launch_config(E, cap, d, f, tdt)
            issued = GK.issued_rows(counts.tolist(), cap, cfg)

            def library(b=buckets, w=w):
                h = torch.bmm(b, w["wg"])
                return torch.bmm(F.silu(h) * torch.bmm(b, w["wu"]), w["wd"])

            if case == "prefill_chunk" and dtype == "float32":
                without_host_sync(lambda: GK.grouped_ffn_cuda(*args))
            check("grouped_ffn", case, dtype,
                  lambda: GK.grouped_ffn_cuda(*args),
                  lambda: grouped_ffn_ref(*args),
                  lambda: grouped_ffn_magnitude(*args),
                  n_bytes, 2 * 3 * d * f * live_rows, library=library,
                  library_label=f"torch.bmm x3 + silu over all {E} experts, dead rows too",
                  shapes=dict(E=E, C=cap, d=d, f=f, tokens=n_tok, top_k=mo.top_k,
                              live_rows=live_rows, live_experts=live_experts,
                              issued_rows=issued, config=dataclasses.asdict(cfg)),
                  primary=(case == "prefill_chunk" and dtype == "float32"))
            del x, r, buckets, args
        del w
        # off the path (FFN_OFF_PATH): every row of the buckets nonzero, so
        # rows at or past the count must come out zero whatever they hold
        for c in FFN_OFF_PATH:
            Ec, C, dc, fc = len(c["counts"]), c["C"], c["d"], c["f"]
            a_ = (randn(Ec, C, dc).to(tdt), randn(Ec, dc, fc, scale=dc ** -0.5).to(tdt),
                  randn(Ec, dc, fc, scale=dc ** -0.5).to(tdt),
                  randn(Ec, fc, dc, scale=fc ** -0.5).to(tdt),
                  torch.tensor(c["counts"], dtype=torch.int32, device=dev))
            live_rows, live_experts = sum(c["counts"]), sum(n > 0 for n in c["counts"])
            check("grouped_ffn", c["case"], dtype,
                  lambda: GK.grouped_ffn_cuda(*a_),
                  lambda: grouped_ffn_ref(*a_),
                  lambda: grouped_ffn_magnitude(*a_),
                  el * (live_experts * 3 * dc * fc + live_rows * dc + Ec * C * dc) + 4 * Ec,
                  2 * 3 * dc * fc * live_rows,
                  library=lambda: torch.bmm(F.silu(torch.bmm(a_[0], a_[1]))
                                            * torch.bmm(a_[0], a_[2]), a_[3]),
                  library_label=f"torch.bmm x3 + silu over all {Ec} experts, dead rows too",
                  shapes=dict(E=Ec, C=C, d=dc, f=fc, counts=list(c["counts"]),
                              config=dataclasses.asdict(GK.launch_config(Ec, C, dc, fc, tdt))),
                  primary=False)
            del a_
    del w32, router
    torch.cuda.empty_cache()
    require(not failed, "; ".join(failed))
    return rows


def lm_backward_checks(cfgs, dev, *, runs=3, ffn_group=40):
    """Phase 6's backward checks: each LM kernel's autograd Function (the
    CUDA kernel forward, the PyTorch ops backward) against autograd through
    the plain version, in fp32 and bf16, gradient by gradient, at
    ``LM_BWD_TOL``.  Flash at the two training shapes of phase 12 (qwen2's
    GQA 12 / 2 heads of 128, causal, 4 x 1,024 tokens; DeepSeek-V2's MLA 128
    heads of 192 / v 128, causal, 1 x 512), with the times of a forward and
    backward each way; the grouped FFN at the ``prefill_chunk`` shape of
    ``lm_kernel_checks``, checked ``ffn_group`` experts at a time (the
    experts are independent, and the whole would hold three fp32 copies of
    the 1.26 B expert weights and their gradients at once)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_magnitude,
                                                         flash_attention_delta_error,
                                                         flash_attention_ref)
    from repro_torch.kernels.moe_dispatch import ops as moe_ops
    from repro_torch.kernels.moe_dispatch.ref import grouped_ffn_bwd_magnitude, grouped_ffn_ref
    from repro_torch.models.moe import capacity

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    def grads(fn, inputs, dy):
        xs = [t.detach().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(fn(*xs), xs, dy)

    rows, failed = [], []

    def compare(name, case, dtype, got, want, mags, names, worst, extra=None):
        tol = LM_BWD_TOL[name]
        for i, (n, g, w, m) in enumerate(zip(names, got, want, mags)):
            g, w = g.float(), w.float()
            limit = tol[0] + tol[1] * m
            if dtype == "bfloat16":
                limit = limit + BF16_ULP * w.abs()
            if extra is not None:
                limit = limit + extra[i]
            err = (g - w).abs()
            ratio = float((err / limit).max())
            if not bool(torch.isfinite(g).all()):
                failed.append(f"{name} backward {case} {dtype} {n}: non-finite")
            worst[n] = max(worst.get(n, (0.0, 0.0)), (ratio, float(err.max())))

    def report(name, case, dtype, worst, **extra):
        for n, (ratio, err) in worst.items():
            if ratio > 1:
                failed.append(f"{name} backward {case} {dtype} d{n}: max abs err {err}, "
                              f"{ratio:.3g} x its elementwise limit")
        row = dict(name=name, case=case, dtype=dtype, tol_abs=LM_BWD_TOL[name][0],
                   tol_rel=LM_BWD_TOL[name][1],
                   tol_ulp=BF16_ULP if dtype == "bfloat16" else 0.0,
                   err_over_limit={n: r for n, (r, _) in worst.items()},
                   max_abs_err={n: e for n, (_, e) in worst.items()}, **extra)
        emit(dict(phase="lm_backward_check", **row))
        rows.append(row)

    dense, moe_cfg = cfgs["dense"], cfgs["moe"]
    m = moe_cfg.mla
    (Bd, Sd), (Bm, Sm) = TRAIN_SHAPES["dense"], TRAIN_SHAPES["moe"]
    cases = [("gqa_train", Bd, Sd, dense.n_heads, dense.n_kv_heads, dense.hdim, dense.hdim),
             ("mla_train", Bm, Sm, moe_cfg.n_heads, moe_cfg.n_heads,
              m.qk_nope + m.qk_rope, m.v_dim)]
    for case, B, S, H, K, D, Dv in cases:
        q32, k32, v32 = randn(B, S, H, D), randn(B, S, K, D), randn(B, S, K, Dv)
        do32 = randn(B, S, H, Dv)
        for dtype in ("float32", "bfloat16"):
            tdt = getattr(torch, dtype)
            q, k, v, do = (t.to(tdt) for t in (q32, k32, v32, do32))

            def kernel_path():
                return grads(lambda *a: flash_ops.flash_attention(*a, causal=True),
                             (q, k, v), do)

            def plain_path():
                return grads(lambda *a: flash_attention_ref(*a, causal=True), (q, k, v), do)

            launches0 = flash_ops.K.LAUNCHES["flash_attention"]
            got = kernel_path()
            require(flash_ops.K.LAUNCHES["flash_attention"] > launches0,
                    f"flash backward {case}: the kernel forward did not launch")
            want = plain_path()
            mags = flash_attention_bwd_magnitude(q, k, v, do, causal=True)
            # in bf16 the backward's delta reads the forward's bf16 output
            extra = (flash_attention_delta_error(q, k, v, do, BF16_ULP, causal=True)
                     if dtype == "bfloat16" else None)
            worst = {}
            compare("flash_attention", case, dtype, got, want, mags, ("q", "k", "v"), worst,
                    extra)
            del got, want, mags, extra
            torch.cuda.empty_cache()
            report("flash_attention", case, dtype, worst,
                   shapes=dict(B=B, S=S, H=H, K=K, D=D, Dv=Dv, causal=True),
                   ms=time_ms(kernel_path, runs, 1), plain_ms=time_ms(plain_path, runs, 1))
            del q, k, v, do
        del q32, k32, v32, do32
        torch.cuda.empty_cache()

    mo = moe_cfg.moe
    E, d, f = mo.n_routed, moe_cfg.d_model, mo.d_ff_expert
    n_tok = PREFILL_LEN // 4
    cap = capacity(moe_cfg, n_tok)
    x = randn(n_tok, d)
    r = moe_ops.route(x, randn(d, E, scale=d ** -0.5), mo.top_k, cap, norm_topk=mo.norm_topk)
    buckets32 = moe_ops.dispatch(x, r, E, cap)
    counts = torch.clamp(r.counts, max=cap).to(torch.int32)
    del x, r
    w32 = [randn(E, d, f, scale=d ** -0.5), randn(E, d, f, scale=d ** -0.5),
           randn(E, f, d, scale=f ** -0.5)]
    dy32 = randn(E, cap, d)
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        worst, t0 = {}, time.perf_counter()
        for e0 in range(0, E, ffn_group):
            sl = slice(e0, min(e0 + ffn_group, E))
            args = [t[sl].to(tdt) for t in [buckets32] + w32]
            c, dy = counts[sl].contiguous(), dy32[sl].to(tdt)
            got = grads(lambda *a: moe_ops.grouped_ffn(*a, c), args, dy)
            want = grads(lambda *a: grouped_ffn_ref(*a, c), args, dy)
            mags = grouped_ffn_bwd_magnitude(*args, c, dy)
            compare("grouped_ffn", "prefill_chunk", dtype, got, want, mags,
                    ("x", "w_gate", "w_up", "w_down"), worst)
            del args, dy, got, want, mags
            torch.cuda.empty_cache()
        report("grouped_ffn", "prefill_chunk", dtype, worst,
               shapes=dict(E=E, C=cap, d=d, f=f, tokens=n_tok,
                           live_rows=int(counts.sum()), expert_group=ffn_group),
               check_s=time.perf_counter() - t0)
    del buckets32, w32, dy32
    torch.cuda.empty_cache()
    require(not failed, "; ".join(failed))
    return rows


# ---------------------------------------------------------------------------
# phase 7: LM serving, the path of the LM kernels
# ---------------------------------------------------------------------------

def device_breakdown(fn, n_calls: int = 1, top: int = 6):
    """Kernel time on the card while ``fn`` runs, from ``torch.profiler``:
    device ms and kernel launches per call, and the largest kernels by
    their share of the device time.  None where the profiler saw no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        return None
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return dict(device_ms=total_us / 1e3 / n_calls,
                launches=sum(e.count for e in kernels) / n_calls,
                top=[dict(kernel=e.key[:80], share=e.self_device_time_total / total_us)
                     for e in kernels[:top]])


def family_inputs(cfg, B, gen, dev):
    """What a prompt of the family carries besides its tokens: the stub
    frontends' embeddings, N(0, 1) from ``gen`` — 256 patches (vlm) or
    ``enc_len`` frames (audio)."""
    import torch
    from repro_torch.models.lm import VLM_PATCHES
    n = {"vlm": VLM_PATCHES, "audio": cfg.enc_len}.get(cfg.family)
    if n is None:
        return {}
    key = "patch_embeds" if cfg.family == "vlm" else "frames"
    return {key: torch.randn((B, n, cfg.d_model), generator=gen, device=dev)}


def fill_cross_cache(cfg, params, cache, frames):
    """Audio: each decoder layer's cross cache gets the K/V its
    cross-attention projects from the encoder output of ``frames``, as
    ``forward`` computes them.  (The serving loop leaves the cache zeros,
    as the reference's does.)"""
    from repro_torch.models import lm
    enc = lm.encode(cfg, params, frames)
    B, T, _ = enc.shape
    xa = params["layers"]["xattn"]
    for i in range(cfg.n_layers):
        for name in ("k", "v"):
            t = enc @ xa["w" + name][i]
            if cfg.qkv_bias:
                t = t + xa["b" + name][i]
            cache["cross"][name][i] = t.reshape(B, T, cfg.n_kv_heads, cfg.hdim)


def decode_vs_forward(cfg, params, dev, dtype, check_len, gen, label):
    """Teacher-forced decode of ``check_len`` tokens (``default_rng(3)``)
    against ``forward`` on them (vlm: no patch prefix; audio: the cross
    cache filled from the encoder's K/V).  Returns (decode error, its
    limit, e_model): in bf16 (``dtype`` None) e_model is the same model's
    bf16 forward against its fp32 forward on the same weights and the limit
    ``BF16_MODEL_MULTIPLE`` x e_model + the fp32 limit; in fp32 e_model is
    None and the limit ``LM_MODEL_TOL``."""
    import numpy as np
    import torch
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import lm
    from repro_torch.models.common import materialize, tree_map

    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, check_len)), device=dev)
    extra = {} if cfg.family == "vlm" else family_inputs(cfg, 1, gen, dev)
    with torch.no_grad():
        out = lm.forward(cfg, params, {"tokens": tokens, **extra})
        full = out[0] if cfg.family == "moe" else out
        require(bool(torch.isfinite(full).all()), f"{label}: non-finite forward logits")
        tol, e_model = LM_MODEL_TOL[cfg.family], None
        if dtype is None:
            p32 = tree_map(lambda t: t.float(), params)
            out32 = lm.forward(cfg, p32, {"tokens": tokens, **extra})
            e_model = scaled_err(full.float(), out32[0] if cfg.family == "moe" else out32)
            tol = BF16_MODEL_MULTIPLE * e_model + tol
            del p32, out32
            torch.cuda.empty_cache()
    cache = materialize(None, lm.cache_template(cfg, 1, check_len),
                        dtype_override=dtype, device=dev)
    if cfg.family == "audio":
        fill_cross_cache(cfg, params, cache, extra["frames"])
    step = make_decode_step(cfg)
    err = 0.0
    for pos in range(check_len):
        logits, cache = step(params, cache, tokens[:, pos:pos + 1], pos)
        require(bool(torch.isfinite(logits).all()),
                f"{label}: non-finite decode logits at {pos}")
        err = max(err, scaled_err(logits.float(), full[:, pos].float()))
    del out, full, cache, extra
    return err, tol, e_model


def one_super_block(cfg):
    """An ssm or hybrid config at its widths, cut to one super-block of two
    blocks: xLSTM one mLSTM and one sLSTM, Zamba2 two Mamba2 blocks and the
    shared attention block."""
    import dataclasses
    if cfg.xlstm is not None:
        return dataclasses.replace(cfg, n_layers=2,
                                   xlstm=dataclasses.replace(cfg.xlstm, slstm_every=2))
    return dataclasses.replace(cfg, n_layers=2, shared_attn_every=2)


def weights_fingerprint(params) -> str:
    """sha256 (16 hex digits) of a parameter tree's bytes, leaf by leaf in
    ``tree_items`` order: the same weights on any machine give the same
    string."""
    import hashlib

    import torch
    from repro_torch.models.common import tree_items
    h = hashlib.sha256()
    for path, t in tree_items(params):
        h.update("/".join(path).encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def recurrent_bf16_check(cfgs, dev, *, check_len=8):
    """bf16 decode of the two recurrent families held against the
    reference's own bf16 error rather than the model's: each at its
    published widths, cut to one super-block of two blocks (xLSTM: an
    mLSTM and an sLSTM; Zamba2: two Mamba2 blocks and the shared attention
    block), bf16 weights drawn on the CPU from seed 0 and moved to the
    card.  On those weights and tokens the reference's bf16 forward lies
    ``BF16_REF_ERR`` from its fp32 forward (``tools/bf16_drift.py`` on the
    CPU; the weights' fingerprint must be the one it saw).  Decode vs
    forward must lie within ``BF16_MODEL_MULTIPLE`` x that + the fp32
    limit, and the port's own bf16-vs-fp32 forward error (e_model) within
    ``BF16_MODEL_MULTIPLE`` x that, so a bf16 fault in the port's forward
    cannot widen its own limit."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.common import materialize, tree_map

    for fam in ("ssm", "hybrid"):
        cfg = cfgs[fam]
        cut = one_super_block(cfg)
        params = materialize(torch.Generator().manual_seed(0), lm.model_template(cut),
                             device="cpu")
        fingerprint = weights_fingerprint(params)
        require(fingerprint == BF16_REF_WEIGHTS[cfg.name],
                f"{cfg.name} cut: weights {fingerprint}, not the ones BF16_REF_ERR "
                f"was measured on ({BF16_REF_WEIGHTS[cfg.name]})")
        params = tree_map(lambda t: t.to(dev), params)
        gen = torch.Generator(device=dev).manual_seed(2)
        err, _, e_model = decode_vs_forward(cut, params, dev, None, check_len, gen,
                                            f"{cfg.name} cut")
        e_ref = BF16_REF_ERR[cfg.name]
        tol = BF16_MODEL_MULTIPLE * e_ref + LM_MODEL_TOL[fam]
        emit(dict(phase="lm_bf16_recurrent_check", model=cfg.name, family=fam,
                  layers=cut.n_layers, d_model=cut.d_model,
                  dtype=str(params["embed"].dtype).replace("torch.", ""),
                  decode_vs_forward_err=err, tol=tol, bf16_vs_fp32_forward_err=e_model,
                  e_model_limit=BF16_MODEL_MULTIPLE * e_ref, reference_bf16_err=e_ref))
        require(err <= tol, f"{cfg.name} cut: bf16 decode vs forward err {err} over {tol}")
        require(e_model <= BF16_MODEL_MULTIPLE * e_ref,
                f"{cfg.name} cut: bf16 vs fp32 forward err {e_model} over "
                f"{BF16_MODEL_MULTIPLE} x the reference's {e_ref}")
        del params
        torch.cuda.empty_cache()


def lm_serving_phase(models, dev, *, requests=8, batch=4, max_prompt=24, max_new=16,
                     check_len=8):
    """``models``: (label, cfg, prefill tokens, dtype) each; dtype None
    serves in the templates' dtype (bf16: parameters and caches, the
    recurrent states carried in fp32), "float32" in fp32.  Returns the
    flash kernel's launches during each model's part of the phase, by
    label."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.serve import serve_requests
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import lm
    from repro_torch.models.common import materialize, tree_items

    flash_launches = {}
    for label, cfg, prefill_len, dtype in models:
        launches0 = FK.LAUNCHES["flash_attention"]
        t0 = time.perf_counter()
        params = materialize(torch.Generator(device=dev).manual_seed(0),
                             lm.model_template(cfg), dtype_override=dtype, device=dev)
        n_params = sum(t.numel() for _, t in tree_items(params))
        param_gb = sum(t.numel() * t.element_size() for _, t in tree_items(params)) / 1e9
        wdtype = str(params["embed"].dtype).replace("torch.", "")
        init_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(2)

        # serving with launch/serve.py's defaults
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, rng.integers(4, max_prompt + 1))
                   for _ in range(requests)]
        res = serve_requests(cfg, params, prompts, batch=batch, max_prompt=max_prompt,
                             max_new=max_new, device=dev, dtype=dtype)
        toks = np.concatenate([o.ravel() for o in res["tokens"]])
        require(toks.size == requests * max_new and toks.min() >= 0
                and toks.max() < cfg.vocab, f"serving {label}: bad tokens")

        err, tol, e_model = decode_vs_forward(cfg, params, dev, dtype, check_len, gen,
                                              label)
        require(err <= tol, f"{label}: decode vs forward err {err} over {tol}")
        step = make_decode_step(cfg)

        # where a decode step's time goes: 8 steps of a batch at the serving
        # batch size, profiled; set against the unprofiled step p50
        cache = materialize(None, lm.cache_template(cfg, batch, max_prompt + max_new),
                            dtype_override=dtype, device=dev)
        tok = torch.zeros((batch, 1), dtype=torch.int64, device=dev)

        def decode_steps(n=8):
            nonlocal cache, tok
            for pos in range(n):
                logits, cache = step(params, cache, tok, pos)
                tok = torch.argmax(logits, -1, keepdim=True)

        decode_steps(2)
        decode_prof = device_breakdown(decode_steps, 8)
        del cache

        # one long prompt through the prefill step: the first call (the
        # allocator grows to the prompt's activations), then a warm one
        prompt = {"tokens": torch.as_tensor(np.random.default_rng(4).integers(
            0, cfg.vocab, (1, prefill_len)), device=dev), **family_inputs(cfg, 1, gen, dev)}
        prefill = make_prefill_step(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prefill_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            nxt = prefill(params, prompt)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        require(tuple(nxt.shape) == (1, cfg.vocab) and bool(torch.isfinite(nxt).all()),
                f"{label}: prefill logits {tuple(nxt.shape)} or non-finite")
        prefill_mem_gb = torch.cuda.max_memory_allocated() / 1e9
        prefill_prof = device_breakdown(lambda: prefill(params, prompt))
        busy = (None if decode_prof is None
                else decode_prof["device_ms"] / 1e3 / res["step_p50_s"])
        flash_launches[label] = FK.LAUNCHES["flash_attention"] - launches0
        emit(dict(phase="lm_serving", model=label, family=cfg.family, dtype=wdtype,
                  layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
                  param_gb=param_gb, init_s=init_s,
                  requests=requests, batch=batch, max_new=max_new,
                  serve_s=res["seconds"], tokens_per_s=res["tokens_per_s"],
                  decode_steps=len(res["step_s"]), step_p50_s=res["step_p50_s"],
                  decode_vs_forward_err=err, tol=tol, bf16_vs_fp32_forward_err=e_model,
                  prefill_tokens=prefill_len,
                  prefill_extra={k: list(v.shape) for k, v in prompt.items()
                                 if k != "tokens"},
                  prefill_first_s=prefill_s[0], prefill_s=prefill_s[1],
                  prefill_peak_mem_gb=prefill_mem_gb,
                  flash_launches=flash_launches[label],
                  decode_device_busy_share=busy, decode_profile=decode_prof,
                  prefill_profile=prefill_prof))
        del params, nxt, prompt
        torch.cuda.empty_cache()
    return flash_launches


# ---------------------------------------------------------------------------
# phases 8-10: the tiled interpreter, the async tier, the tuned route
# ---------------------------------------------------------------------------

def tiled_phase(graphs, dev, *, width=WIDTH, grid=64):
    """``run_tiled`` on the serving batch, as served (COO tiles of the
    server's canonical shapes) and as CSR tiles of the same padded graph,
    with kernel dispatch on and off, against ``run_reference``."""
    import torch
    from repro_torch.core import compiler
    from repro_torch.core.executor import run_reference, run_tiled
    from repro_torch.core.tiling import grid_tile
    from repro_torch.gnn import graphs as G
    from repro_torch.gnn import models as M
    from repro_torch.serve import ShapeRegistry

    padded, coo_tiles, _, _ = ShapeRegistry().canonical(
        "shapes", G.batch_graphs(graphs).graph)
    csr_tiles = grid_tile(padded, grid, grid, sparse=True, layout="csr")
    for name in ("gcn", "gat"):
        tr = M.trace_stacked(name, 2, width, width, width)
        c = compiler.compile_gnn(tr)
        params = M.init_params(tr, seed=0)
        inputs = M.init_inputs(tr, padded, seed=0)
        want = run_reference(tr, padded, inputs, params, device=dev)[0]
        for tiles in (coo_tiles, csr_tiles):
            for dispatch in (True, False):
                secs = []
                for _ in range(2):              # the first pass, a warm one
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = run_tiled(c, padded, tiles, inputs, params,
                                    kernel_dispatch=dispatch, device=dev)[0]
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                what = f"tiled {name} {tiles.layout} dispatch={dispatch}"
                require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                        f"{what}: output shape {tuple(got.shape)} or non-finite")
                err = scaled_err(got, want)
                require(err <= MODEL_TOL[name], f"{what}: err {err} over {MODEL_TOL[name]}")
                emit(dict(phase="tiled", model=f"{name}_x2", layout=tiles.layout,
                          kernel_dispatch=dispatch, vertices=padded.n_vertices,
                          edges=padded.n_edges, tiles=tiles.n_tiles,
                          s_max=tiles.s_max, e_max=tiles.e_max,
                          first_s=secs[0], warm_s=secs[1], err_vs_oracle=err,
                          tol=MODEL_TOL[name]))
        del want, got
    torch.cuda.empty_cache()


def async_serving_phase(graphs, dev, *, width=WIDTH, max_batch=16,
                        deadline_s=2.0, samples=4):
    """``AsyncInferenceServer`` with 2-layer gcn and gat, warmed on the
    class, under ``len(graphs)`` single-graph requests to each model."""
    import numpy as np
    import torch
    from repro_torch.core import compiler
    from repro_torch.core.executor import run_reference
    from repro_torch.gnn import models as M
    from repro_torch.serve import AsyncInferenceServer

    srv = AsyncInferenceServer(default_deadline_s=deadline_s, n_workers=2)
    traces = {}
    try:
        for name in ("gcn", "gat"):
            tr = traces[name] = M.trace_stacked(name, 2, width, width, width)
            srv.register_model(
                name, compiler.compile_gnn(tr), M.init_params(tr, seed=0),
                max_batch=max_batch, warmup_graphs=[graphs[0]], device=dev)
        t0 = time.perf_counter()
        srv.start()
        while not srv.warmup_done():
            require(time.perf_counter() - t0 < 300, "async: warm-up over 300 s")
            time.sleep(0.01)
        warmup_s = time.perf_counter() - t0
        require(srv.metrics.snapshot()["shed"].get("warmup-failed", 0) == 0,
                "async: a warm-up batch failed")
        builds = srv.cache.stats.compiles      # the shared cache's, both models
        inputs = {n: [M.init_inputs(traces[n], g, seed=i) for i, g in enumerate(graphs)]
                  for n in traces}
        t0 = time.perf_counter()
        tickets = {n: srv.submit_many(graphs, inputs[n], model=n, deadline_s=deadline_s)
                   for n in traces}
        outs = {n: [t.result(timeout=120) for t in ts] for n, ts in tickets.items()}
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        snap = srv.metrics.snapshot()
    finally:
        srv.close(timeout=120)
    for n, ts in tickets.items():
        require(all(t.ok for t in ts),
                f"async {n}: {sum(not t.ok for t in ts)} requests shed: {snap['shed']}")
    rebuilt = srv.cache.stats.compiles - builds
    require(builds == len(traces) and rebuilt == 0,
            f"async: {builds} builds in warm-up, {rebuilt} after it; expected "
            f"{len(traces)} then 0")
    errs = {}
    for n in traces:
        params = M.init_params(traces[n], seed=0)
        errs[n] = []
        for i in np.linspace(0, len(graphs) - 1, samples).astype(int):
            want = run_reference(traces[n], graphs[i], inputs[n][i], params, device=dev)[0]
            got = outs[n][i][0]
            require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                    f"async {n}: request {i} output shape or non-finite")
            errs[n].append(scaled_err(got, want))
        require(max(errs[n]) <= MODEL_TOL[n],
                f"async {n}: err {max(errs[n])} over {MODEL_TOL[n]}")
    emit(dict(phase="async_serving", models=["gcn_x2", "gat_x2"],
              requests_per_model=len(graphs), max_batch=max_batch,
              deadline_s=deadline_s, warmup_s=warmup_s, serve_s=serve_s,
              requests_per_s=2 * len(graphs) / serve_s,
              builds_at_warmup=builds, builds_after_warmup=rebuilt,
              cache=srv.cache.stats.as_dict(),
              latency_p50_s=snap["latency_s"]["p50"],
              latency_p99_s=snap["latency_s"]["p99"],
              batch_fill=snap["batch_fill"], shed=snap["shed"],
              queue_depth=snap["queue_depth"], queue_wait_s=snap["queue_wait_s"],
              metrics=snap, err_vs_oracle=errs, tol={n: MODEL_TOL[n] for n in traces}))
    torch.cuda.empty_cache()


def autotune_phase(graphs, dev, *, width=WIDTH, max_evals=24, top=2, repeats=5):
    """``tune_for_class`` for 2-layer gcn on the serving batch's merged
    graph (simulator search, then each finalist timed on the card by CUDA
    events), then the class served through the tuned route."""
    import numpy as np
    import torch
    from repro_torch.core import compiler
    from repro_torch.core.executor import run_reference
    from repro_torch.gnn import graphs as G
    from repro_torch.gnn import models as M
    from repro_torch.launch import autotune as AT
    from repro_torch.serve import InferenceServer, quantize, size_class

    tr = M.trace_stacked("gcn", 2, width, width, width)
    c = compiler.compile_gnn(tr)
    params = M.init_params(tr, seed=0)
    batch = G.batch_graphs(graphs)
    merged = batch.graph
    class_key = (c.name, c.n_layers, size_class(graphs[0]),
                 quantize(len(graphs), floor=1))
    cache = AT.TuneCache()
    t0 = time.perf_counter()
    res = AT.tune_for_class(c, merged, class_key, cache=cache,
                            inputs=M.init_inputs(tr, merged, seed=0), params=params,
                            max_shards=1, max_evals=max_evals, top=top,
                            repeats=repeats, device=dev)
    tune_s = time.perf_counter() - t0
    cfg = res.best.config
    require(len(res.confirmed) == min(top, len(res.trials))
            and all(t.wall_s and t.wall_s > 0 for t in res.confirmed),
            "autotune: a finalist has no wall-clock time")
    require(cache.get(AT.program_key(c, True), class_key) == cfg,
            "autotune: the winner is not in the tune cache")

    server = InferenceServer(c, params, tune_cache=cache, device=dev)
    inputs = [M.init_inputs(tr, g, seed=i) for i, g in enumerate(graphs)]
    lat = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = server.submit(graphs, inputs)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    tuned_key = ("tuned",) + cfg.key()
    require(any(tuned_key in k for k in server.shapes._shapes),
            f"autotune: no registration under {tuned_key}")
    require(server.compile_count == 1 and server.cache_hits == 1,
            f"autotune: builds={server.compile_count} hits={server.cache_hits}, "
            "expected 1 build then a hit")
    got = torch.cat([o[0] for o in outs])
    merged_in = {k: np.concatenate([inp[k] for inp in inputs]) for k in inputs[0]}
    want = run_reference(tr, merged, merged_in, params, device=dev)[0]
    require(got.shape == want.shape and bool(torch.isfinite(got).all()),
            f"autotune: output shape {tuple(got.shape)} or non-finite")
    err = scaled_err(got, want)
    require(err <= MODEL_TOL["gcn"], f"autotune: err {err} over {MODEL_TOL['gcn']}")
    emit(dict(phase="autotune", model="gcn_x2", vertices=merged.n_vertices,
              edges=merged.n_edges, evals=res.n_evals, tune_s=tune_s,
              wall_clock="cuda_events" if dev.type == "cuda" else "perf_counter",
              repeats=repeats,
              finalists=[dict(config=t.config.to_dict(), cycles=t.cycles,
                              wall_s=t.wall_s) for t in res.confirmed],
              best=cfg.to_dict(), tuned_key=list(tuned_key),
              layout_signature=cache.entry(AT.program_key(c, True),
                                           class_key)["layout_signature"],
              serve_first_s=lat[0], serve_warm_s=lat[1],
              builds=server.compile_count, hits=server.cache_hits,
              err_vs_oracle=err, tol=MODEL_TOL["gcn"]))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 11: sharded execution over logical shards of one card
# ---------------------------------------------------------------------------

def _timed(fn, dev, repeats: int):
    """The last result of ``fn`` and the seconds of each of ``repeats``
    calls, host-timed to a synchronize."""
    import torch
    secs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return out, secs


def sharded_phase(graphs, whole, whole_tiles, dev, *, width=WIDTH,
                  n_shards=4, repeats=3):
    """``ShardedRunner`` over ``n_shards`` logical shards of ``dev``: the
    whole graph on its CSR tiles, the serving batch through the sharded
    route, then a 2-D mesh pass, a scan pass of sage and a sharded
    autotune finalist on the serving batch.

    Returns the tile kernels' launches made by the sharded calls alone, by
    part: the unsharded baselines run beside them (``run_pipelined``, the
    unsharded server) are left out of the counts."""
    import numpy as np
    import torch
    from repro_torch.core import compiler
    from repro_torch.core.analysis import exchange_census, verify_exchange
    from repro_torch.core.executor import run_reference
    from repro_torch.core.pipeline import PipelinedRunner, ShardedRunner
    from repro_torch.core.tiling import exchange_sets
    from repro_torch.gnn import graphs as G
    from repro_torch.gnn import models as M
    from repro_torch.kernels.tile_spmm import kernel as K
    from repro_torch.launch import autotune as AT
    from repro_torch.serve import InferenceServer, ShapeRegistry

    launches = {}

    def counted(fn, part):
        """``fn``, adding the tile kernels each call launches to
        ``launches[part]``."""
        def call(*args, **kw):
            before = dict(K.LAUNCHES)
            try:
                return fn(*args, **kw)
            finally:
                got = launches.setdefault(part, {})
                for name, n in K.LAUNCHES.items():
                    got[name] = got.get(name, 0) + n - before.get(name, 0)
        return call

    card = torch.device(dev.type, 0) if dev.type == "cuda" else dev
    mesh = [card] * n_shards
    emit(dict(phase="sharded_mesh", devices=[str(d) for d in mesh],
              note=f"{n_shards} logical shards on one card: each shard's "
                   "work and every exchange run on the same device"))

    # -- the whole graph, mincut plan: oracle, census, exchange, speed
    for name in ("gcn", "gat"):
        tr = M.trace_stacked(name, 2, width, width, width)
        c = compiler.compile_gnn(tr)
        params = M.init_params(tr, seed=0)
        inputs = M.init_inputs(tr, whole, seed=0)
        sp = c.schedule(True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = ShardedRunner(c, whole, whole_tiles, n_shards, mode="mincut",
                               devices=mesh, device=dev)
        build_s = time.perf_counter() - t0
        run = counted(runner, "whole_graph")
        (got,), first = _timed(lambda: run(inputs, params), dev, 1)
        per_pass = runner.mesh.collectives
        census = exchange_census(sp).n_collectives
        require(per_pass == census,
                f"sharded {name}: {per_pass} exchanges a pass, census {census}")
        errors = [d.format() for d in verify_exchange(
            sp, tiles=whole_tiles, plan=runner.plan) if d.severity == "error"]
        require(not errors, f"sharded {name}: verify_exchange: {errors}")
        _, warm = _timed(lambda: run(inputs, params), dev, repeats)
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = run_reference(tr, whole, inputs, params, device=dev)[0]
        require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                f"sharded {name}: output shape {tuple(got.shape)} or non-finite")
        err = scaled_err(got, want)
        require(err <= MODEL_TOL[name], f"sharded {name}: err {err} over {MODEL_TOL[name]}")
        del want, got
        plain = PipelinedRunner(c, whole, whole_tiles, device=dev)
        plain(inputs, params)
        _, plain_warm = _timed(lambda: plain(inputs, params), dev, repeats)
        emit(dict(phase="sharded_whole_graph", model=f"{name}_x2", layout="csr",
                  graph=whole.name, vertices=whole.n_vertices,
                  edges=whole.n_edges, shards=n_shards, mode="mincut",
                  local_parts=runner.plan.n_local_parts, caps=list(runner.caps),
                  build_s=build_s, first_s=first[0],
                  warm_s=statistics.median(warm), warm_runs_s=warm,
                  pipelined_warm_s=statistics.median(plain_warm),
                  pipelined_runs_s=plain_warm,
                  exchanges_per_pass=per_pass, census=census,
                  # rows an interior (restricted) exchange ships, the rows
                  # remote shards read, and the full padded layout
                  restricted_rows=n_shards * runner.caps[-1],
                  cut_rows=exchange_sets(whole_tiles, runner.plan).cut_rows,
                  full_rows=n_shards * runner.plan.n_local_parts * runner.dmax,
                  err_vs_oracle=err, tol=MODEL_TOL[name], peak_mem_gb=peak))
        del runner, plain
        torch.cuda.empty_cache()

    # -- the serving batch through the sharded route, against the
    # unsharded server
    batch = G.batch_graphs(graphs)
    for name in ("gcn", "gat"):
        tr = M.trace_stacked(name, 2, width, width, width)
        c = compiler.compile_gnn(tr)
        params = M.init_params(tr, seed=0)
        inputs = [M.init_inputs(tr, g, seed=i) for i, g in enumerate(graphs)]
        want = torch.cat([o[0] for o in InferenceServer(
            c, params, device=dev).submit(graphs, inputs)])
        server = InferenceServer(c, params, shard_devices=n_shards,
                                 shard_mesh_devices=mesh, device=dev)
        submit = counted(server.submit, "serving")
        lat = []
        for _ in range(3):
            outs, secs = _timed(lambda: submit(graphs, inputs), dev, 1)
            lat += secs
        st = server.stats()
        require(server.compile_count == 1 and server.cache_hits == 2,
                f"sharded serving {name}: builds={server.compile_count} "
                f"hits={server.cache_hits}, expected 1 build then 2 hits")
        require(st["sharded_batches"] == 3,
                f"sharded serving {name}: {st['sharded_batches']} of 3 batches sharded")
        got = torch.cat([o[0] for o in outs])
        require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                f"sharded serving {name}: output shape or non-finite")
        err = scaled_err(got, want)
        require(err <= MODEL_TOL[name],
                f"sharded serving {name}: err {err} vs unsharded over {MODEL_TOL[name]}")
        emit(dict(phase="sharded_serving", model=f"{name}_x2", layout="coo",
                  shards=n_shards, graphs=len(graphs),
                  vertices=batch.graph.n_vertices, cold_s=lat[0],
                  warm_p50_s=statistics.median(lat[1:]),
                  builds=server.compile_count, hits=server.cache_hits,
                  sharded_batches=st["sharded_batches"],
                  err_vs_unsharded=err, tol=MODEL_TOL[name]))
        del server
        torch.cuda.empty_cache()

    # -- other paths on the serving batch's padded graph (COO, as served)
    padded, tiles, _, _ = ShapeRegistry().canonical("shapes", batch.graph)
    in_deg = np.bincount(padded.dst, minlength=padded.n_vertices)
    for name, n_sh, M_axis, dispatch in (("gcn", 2, 2, True), ("sage", n_shards, 1, False)):
        tr = M.trace_stacked(name, 2, width, width, width)
        c = compiler.compile_gnn(tr)
        params = M.init_params(tr, seed=0)
        inputs = M.init_inputs(tr, padded, seed=0)
        runner = ShardedRunner(c, padded, tiles, n_sh, mode="mincut",
                               model_axis=M_axis, kernel_dispatch=dispatch,
                               devices=[card] * (n_sh * M_axis), device=dev)
        run = counted(runner, "paths")
        (got,), secs = _timed(lambda: run(inputs, params), dev, 1)
        want = run_reference(tr, padded, inputs, params, device=dev)[0]
        rows = torch.as_tensor(in_deg > 0, device=got.device)
        if name == "sage":      # the -1e30 empty-max sentinel (ROADMAP C.1)
            got, want = got[rows], want[rows]
        require(bool(torch.isfinite(got).all()), f"sharded {name}: non-finite")
        err = scaled_err(got, want)
        require(err <= MODEL_TOL[name],
                f"sharded {name} K={n_sh} M={M_axis}: err {err}")
        emit(dict(phase="sharded_path", model=f"{name}_x2", shards=n_sh,
                  model_axis=M_axis, kernel_dispatch=dispatch,
                  rows_checked=int(rows.sum()) if name == "sage" else padded.n_vertices,
                  exchanges_per_pass=runner.mesh.collectives, first_s=secs[0],
                  err_vs_oracle=err, tol=MODEL_TOL[name]))
        del runner

    tr = M.trace_stacked("gcn", 2, width, width, width)
    c = compiler.compile_gnn(tr)
    trial = AT.padded_cost(c, batch.graph, AT.TileConfig(
        n_dst_parts=16, n_src_parts=16, n_buckets=2, n_shards=2,
        layout="csr", shard_mode="mincut"))
    counted(AT.confirm_wallclock, "autotune")(c, batch.graph, [trial],
                         M.init_inputs(tr, batch.graph, seed=0),
                         M.init_params(tr, seed=0), top=1, repeats=repeats,
                         device=dev, devices=[card] * 2)
    require(trial.wall_s is not None and trial.wall_s > 0,
            "sharded autotune: the 2-shard finalist has no wall-clock time")
    emit(dict(phase="sharded_autotune", model="gcn_x2",
              config=trial.config.to_dict(), cycles=trial.cycles,
              wall_s=trial.wall_s, repeats=repeats))
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 12: training on one card
# ---------------------------------------------------------------------------

def _leaves_equal(a, b) -> bool:
    """Two trees hold the same tensors bit for bit (bf16 by their 16-bit
    patterns; dtypes must match too)."""
    import torch
    from repro_torch.checkpointing.ckpt import _leaves
    la, lb = list(_leaves(a)), list(_leaves(b))
    if [k for k, _ in la] != [k for k, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        if not torch.equal(x, y):
            return False
    return True


def _adamw_param_limit(p, m, v, lr, step, tol, *, b1=0.9, b2=0.95, eps=1e-8):
    """Elementwise: how far params ``p`` after AdamW's first step at a rate
    ``lr`` > 0 (from equal params) may lie from another run's when the
    moments ``m``, ``v`` after step ``step`` are each within ``tol`` of
    their leaf's largest entry, plus one fp32 ulp of ``p``.  The update u =
    m^/(sqrt(v^) + eps) with m^ within dm and sqrt(v^) + eps within [lo,
    hi] moves by at most dm / lo + |m^| (hi - lo) / (lo hi)."""
    import torch
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    mh, vh = m.abs() / bc1, v / bc2
    dm = tol * float(mh.max())
    dv = tol * float(vh.max())
    lo = torch.sqrt(torch.clamp(vh - dv, min=0.0)) + eps
    hi = torch.sqrt(vh + dv) + eps
    du = dm / lo + mh * (hi - lo) / (lo * hi)
    return lr * du + torch.finfo(torch.float32).eps * p.abs()


def training_parity(cfg, dev, *, batch, seq):
    """Two training steps of ``cfg`` (fp32) with the kernels, and the same
    two with the model's attention through the plain version
    (``flash_attention_ref``, differentiated by autograd): the loss and grad
    norm of each step, the moments after the second, and the params after
    it (the WSD rate is 0 at step 0 and lr_1 > 0 at step 1).  A param may
    differ by what the second update moves when the moments are off by
    ``TRAIN_PARITY_TOL`` of their leaf's largest entry
    (:func:`_adamw_param_limit`): a parameter whose gradient is rounding
    noise in both runs, as some of the key bias's are (its rows RoPE leaves
    unrotated shift every score of a row alike), moves by the noise."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch.steps import make_train_step, opt_state_bits
    from repro_torch.launch.train import batch_tensors
    from repro_torch.models import attention, lm
    from repro_torch.models.common import materialize, tree_items
    from repro_torch.optim.adamw import adamw_init

    pipe = TokenPipeline(cfg, seq_len=seq, global_batch=batch)
    data = [batch_tensors(pipe.global_batch_at(i), dev) for i in range(2)]

    def init():
        return materialize(torch.Generator(device=dev).manual_seed(0),
                           lm.model_template(cfg), dtype_override="float32", device=dev)

    def two_steps(plain):
        params = init()
        opt = adamw_init(params, opt_state_bits(cfg))
        step = make_train_step(cfg, peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS)
        kernel_flash = attention.flash_attention
        if plain:
            attention.flash_attention = flash_attention_ref
        try:
            metrics = []
            for b in data:
                params, opt, m = step(params, opt, b)
                metrics.append({k: float(v) for k, v in m.items()})
            return params, opt, metrics
        finally:
            attention.flash_attention = kernel_flash

    pk, ok, mk = two_steps(False)
    pp, op, mp = two_steps(True)
    rel = {f"{k}_{i}": abs(a[k] - b[k]) / max(1e-30, abs(b[k]))
           for i, (a, b) in enumerate(zip(mk, mp)) for k in ("loss", "grad_norm")}
    moment = 0.0
    for tree_k, tree_p in ((ok.m, op.m), (ok.v, op.v)):
        for (_, a), (_, b) in zip(tree_items(tree_k), tree_items(tree_p)):
            moment = max(moment, float((a - b).abs().max()) / max(1e-30, float(b.abs().max())))
    param_ratio = 0.0
    for (_, a), (_, b), (_, m), (_, v) in zip(tree_items(pk), tree_items(pp),
                                              tree_items(op.m), tree_items(op.v)):
        limit = _adamw_param_limit(b, m, v, mk[1]["lr"], 2, TRAIN_PARITY_TOL)
        param_ratio = max(param_ratio, float(((a - b).abs() / limit).max()))
    row = dict(model=cfg.name, layers=cfg.n_layers, batch=batch, seq=seq, dtype="float32",
               loss=[m["loss"] for m in mk], plain_loss=[m["loss"] for m in mp],
               grad_norm=[m["grad_norm"] for m in mk],
               plain_grad_norm=[m["grad_norm"] for m in mp], lr=[m["lr"] for m in mk],
               rel_err=rel, moment_err=moment, param_err_over_limit=param_ratio,
               tol=TRAIN_PARITY_TOL)
    emit(dict(phase="training_parity", **row))
    require(mk[1]["lr"] > 0, f"training parity: the second step's rate is {mk[1]['lr']}")
    require(all(v <= TRAIN_PARITY_TOL for v in rel.values())
            and moment <= TRAIN_PARITY_TOL and param_ratio <= 1.0,
            f"training steps with the kernels vs the plain versions: {row}")
    del pk, ok, pp, op
    torch.cuda.empty_cache()


def gradient_parity(cfg, dev, *, batch, seq):
    """The loss and gradients of ``cfg`` (fp32, one batch) with both LM
    kernels, and with attention and the expert FFN through their plain
    versions (``flash_attention_ref``, ``grouped_ffn_ref``, differentiated by
    autograd): the loss, and each gradient leaf within ``TRAIN_PARITY_TOL``
    of its largest entry.  No optimizer step (the moments of a full-width
    MoE would not fit beside two sets of fp32 gradients); the AdamW update
    is held by ``training_parity``."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.moe_dispatch import kernel as GK
    from repro_torch.kernels.moe_dispatch import ops as moe_ops
    from repro_torch.kernels.moe_dispatch.ref import grouped_ffn_ref
    from repro_torch.launch.train import batch_tensors
    from repro_torch.models import attention, lm
    from repro_torch.models.common import materialize, tree_items

    data = batch_tensors(TokenPipeline(cfg, seq_len=seq, global_batch=batch)
                         .global_batch_at(0), dev)
    params = materialize(torch.Generator(device=dev).manual_seed(0),
                         lm.model_template(cfg), dtype_override="float32", device=dev)
    leaves = [t for _, t in tree_items(params)]

    def loss_and_grads(plain):
        kernels = attention.flash_attention, moe_ops.grouped_ffn
        if plain:
            attention.flash_attention, moe_ops.grouped_ffn = flash_attention_ref, grouped_ffn_ref
        try:
            for t in leaves:
                t.requires_grad_(True)
            loss = lm.loss_fn(cfg, params, data)
            return float(loss.detach()), torch.autograd.grad(loss, leaves)
        finally:
            attention.flash_attention, moe_ops.grouped_ffn = kernels
            for t in leaves:
                t.requires_grad_(False)

    flash0, ffn0 = FK.LAUNCHES["flash_attention"], GK.LAUNCHES["grouped_ffn"]
    lk, gk = loss_and_grads(False)
    require(FK.LAUNCHES["flash_attention"] > flash0 and GK.LAUNCHES["grouped_ffn"] > ffn0,
            f"gradient parity {cfg.name}: a kernel did not launch")
    lp, gp = loss_and_grads(True)
    grad_err = max(float((a - b).abs().max()) / max(1e-30, float(b.abs().max()))
                   for a, b in zip(gk, gp))
    row = dict(model=cfg.name, layers=cfg.n_layers, batch=batch, seq=seq, dtype="float32",
               loss=lk, plain_loss=lp, loss_rel_err=abs(lk - lp) / max(1e-30, abs(lp)),
               grad_err=grad_err, tol=TRAIN_PARITY_TOL)
    emit(dict(phase="gradient_parity", **row))
    require(row["loss_rel_err"] <= TRAIN_PARITY_TOL and grad_err <= TRAIN_PARITY_TOL,
            f"gradients with the kernels vs the plain versions: {row}")
    del params, leaves, gk, gp
    torch.cuda.empty_cache()


def train_model(label, cfg, dev, *, batch, seq, steps=TRAIN_STEPS):
    """``steps`` steps of ``make_train_step`` from the templates' dtype
    (bf16 params, fp32 moments at these sizes), on the token pipeline's
    batches: losses (finite), step seconds (host clock to a synchronize),
    tokens/s, peak memory, and the device busy share of the last step
    (``torch.profiler``'s device time over the median unprofiled step)."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import make_train_step, opt_state_bits
    from repro_torch.launch.train import batch_tensors
    from repro_torch.models import lm
    from repro_torch.models.common import materialize, tree_items
    from repro_torch.optim.adamw import adamw_init

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = materialize(torch.Generator(device=dev).manual_seed(0),
                         lm.model_template(cfg), device=dev)
    bits = opt_state_bits(cfg)
    opt = adamw_init(params, bits)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_items(params))
    step_fn = make_train_step(cfg, peak_lr=TRAIN_LR, total_steps=steps)
    pipe = TokenPipeline(cfg, seq_len=seq, global_batch=batch)
    losses, grad_norms, step_s = [], [], []

    def record(metrics):
        losses.append(float(metrics["loss"]))
        grad_norms.append(float(metrics["grad_norm"]))
        require(all(map(lambda v: v == v and abs(v) != float("inf"),
                        (losses[-1], grad_norms[-1]))),
                f"training {label}: step {len(losses) - 1} loss {losses[-1]} "
                f"grad norm {grad_norms[-1]}")

    for s in range(steps - 1):
        data = batch_tensors(pipe.global_batch_at(s), dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, data)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        record(metrics)
    data = batch_tensors(pipe.global_batch_at(steps - 1), dev)
    box = {}

    def last_step():
        box["m"] = step_fn(params, opt, data)[2]

    prof = device_breakdown(last_step)
    record(box["m"])
    warm = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
    row = dict(model=label, family=cfg.family, layers=cfg.n_layers, params=n_params,
               dtype=str(params["embed"].dtype).replace("torch.", ""), state_bits=bits,
               batch=batch, seq=seq, steps=steps, losses=losses, grad_norms=grad_norms,
               init_s=init_s, step_s=step_s, warm_step_s=warm,
               tokens_per_s=batch * seq / warm,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               device_busy_share=None if prof is None else prof["device_ms"] / 1e3 / warm,
               profile=prof)
    emit(dict(phase="training", **row))
    del params, opt, data, box
    torch.cuda.empty_cache()
    return row


def checkpoint_roundtrip(cfg, dev, *, batch, seq):
    """Two bf16 training steps of ``cfg``, a checkpoint of (params,
    moments) after step 1 restored bit for bit, and step 2 from the restore
    equal, bit for bit, to step 2 from the live state.  Deterministic
    algorithms are on for the check (the embedding's backward scatters)."""
    import shutil

    import torch
    from repro_torch.checkpointing import restore_checkpoint, save_checkpoint
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import make_train_step, opt_state_bits
    from repro_torch.launch.train import batch_tensors
    from repro_torch.models import lm
    from repro_torch.models.common import materialize
    from repro_torch.optim.adamw import adamw_init

    root = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(root, ignore_errors=True)
    params = materialize(torch.Generator(device=dev).manual_seed(0),
                         lm.model_template(cfg), device=dev)
    opt = adamw_init(params, opt_state_bits(cfg))
    step_fn = make_train_step(cfg, peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS)
    pipe = TokenPipeline(cfg, seq_len=seq, global_batch=batch)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for s in range(2):
            params, opt, _ = step_fn(params, opt, batch_tensors(pipe.global_batch_at(s), dev))
        t0 = time.perf_counter()
        save_checkpoint(str(root), 1, {"params": params, "opt": opt})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = restore_checkpoint(str(root), 1, {"params": params, "opt": opt})
        restore_s = time.perf_counter() - t0
        restored_equal = _leaves_equal(back, {"params": params, "opt": opt})
        data = batch_tensors(pipe.global_batch_at(2), dev)
        pa, oa, ma = step_fn(params, opt, data)
        pb, ob, mb = step_fn(back["params"], back["opt"], data)
        step2_equal = (_leaves_equal({"p": pa, "o": oa}, {"p": pb, "o": ob})
                       and float(ma["loss"]) == float(mb["loss"]))
        ckpt_gb = sum(f.stat().st_size for f in root.rglob("*")) / 1e9
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    row = dict(model=cfg.name, layers=cfg.n_layers, dtype="bfloat16", batch=batch,
               seq=seq, checkpoint_gb=ckpt_gb, save_s=save_s, restore_s=restore_s,
               restored_bit_exact=restored_equal, step2_bit_exact=step2_equal)
    emit(dict(phase="training_checkpoint", **row))
    require(restored_equal, "checkpoint restore is not bit-exact")
    require(step2_equal, "step 2 from the restored checkpoint differs from step 2 without it")
    del params, opt, back, pa, oa, pb, ob
    torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# phase 13: GNN training through the scan path
# ---------------------------------------------------------------------------

def _gnn_grads(run, inputs, labels, params):
    """The training loss through ``run`` and its gradients, by name."""
    import torch
    from repro_torch.launch.train_gnn import gnn_loss
    loss = gnn_loss(run(inputs, params)[0], labels)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def _grad_err_over_limit(got, want) -> float:
    """The worst leaf's |got - want| over GNN_GRAD_TOL x max(1, max|want|);
    inf where ``got`` is not finite."""
    import torch
    worst = 0.0
    for k, w in want.items():
        if not bool(torch.isfinite(got[k]).all()):
            return float("inf")
        lim = GNN_GRAD_TOL * max(1.0, float(w.abs().max()))
        worst = max(worst, float((got[k] - w).abs().max()) / lim)
    return worst


def _fresh(params):
    return {k: v.detach().clone().requires_grad_() for k, v in params.items()}


def gnn_oracle_parity(g, dev, *, width=512):
    """The example's 3-layer GCN at ``width`` on ``g``: the loss and
    gradients through ``PipelinedRunner``'s scan path against autograd
    through ``run_reference``, leaf by leaf; then two ``gnn_train_step``s of
    each from the same params: losses (relative), moments (of their leaf's
    largest entry) and params (over the sum of both steps'
    ``_adamw_param_limit``)."""
    import torch
    from repro_torch.core.executor import run_reference
    from repro_torch.launch.train_gnn import (LR, gnn_train_step, init_problem,
                                              scan_runner, trace_mlp_gcn)
    from repro_torch.optim.adamw import adamw_init

    tr = trace_mlp_gcn(width, 16)
    runs = {"scan": scan_runner(tr, g, dev),
            "oracle": lambda i, p: run_reference(tr, g, i, p, device=dev)}
    params, inputs, labels = init_problem(tr, g, 16, dev)
    loss_s, grads_s = _gnn_grads(runs["scan"], inputs, labels, params)
    loss_o, grads_o = _gnn_grads(runs["oracle"], inputs, labels, params)
    grad_ratio = _grad_err_over_limit(grads_s, grads_o)
    steps = {}
    for label, run in runs.items():
        p = _fresh(params)
        opt = adamw_init(p)
        losses, moments = [], []
        for _ in range(2):
            loss, _, opt = gnn_train_step(run, inputs, labels, p, opt)
            losses.append(float(loss))
            moments.append({k: (opt.m[k].clone(), opt.v[k].clone()) for k in p})
        steps[label] = (p, losses, moments)
    (ps, ls, ms), (po, lo, mo) = steps["scan"], steps["oracle"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ls, lo))
    moment = max(float((a - b).abs().max()) / max(1e-30, float(b.abs().max()))
                 for s in range(2) for k in params
                 for a, b in zip(ms[s][k], mo[s][k]))
    param_ratio = 0.0
    for k in params:
        limit = sum(_adamw_param_limit(po[k].detach(), *mo[s][k], LR, s + 1,
                                       GNN_GRAD_TOL) for s in range(2))
        param_ratio = max(param_ratio,
                          float(((ps[k] - po[k]).detach().abs() / limit).max()))
    row = dict(model="gcn3", width=width, graph=g.name, vertices=g.n_vertices,
               edges=g.n_edges, loss=loss_s, oracle_loss=loss_o,
               grad_err_over_limit=grad_ratio, step_losses=ls, oracle_step_losses=lo,
               step_loss_rel_err=loss_rel, moment_err=moment,
               param_err_over_limit=param_ratio, tol=GNN_GRAD_TOL)
    emit(dict(phase="gnn_training_parity", **row))
    require(grad_ratio <= 1.0 and loss_rel <= GNN_GRAD_TOL
            and moment <= GNN_GRAD_TOL and param_ratio <= 1.0,
            f"GNN training through the scan path vs the oracle: {row}")


def gnn_train_run(g, dev, *, width=GNN_TRAIN_WIDTH, steps=GNN_TRAIN_STEPS):
    """``steps`` steps of the example's loop at ``width`` on ``g``: losses
    (finite, the mean of the last five below the mean of the five before),
    the median warm step by CUDA events, vertices x epochs a second, peak
    memory, and the device busy share of the last step (``torch.profiler``'s
    device time over the median warm step) with its largest device ops.
    The loss is not held below its start: the recipe's first AdamW steps
    at a rate of 3e-3 raise it at this width before it falls, as the
    reference's own loop does at width 2,048
    (``tests/test_torch_gnn_train.py``)."""
    import torch
    from repro_torch.launch.train_gnn import (gnn_train_step, init_problem,
                                              scan_runner, trace_mlp_gcn)
    from repro_torch.optim.adamw import adamw_init

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = trace_mlp_gcn(width, 16)
    runner = scan_runner(tr, g, dev)
    params, inputs, labels = init_problem(tr, g, 16, dev)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    box = {"opt": opt}
    losses, step_s = [], []

    def step():
        loss, gnorm, box["opt"] = gnn_train_step(runner, inputs, labels, params,
                                                 box["opt"])
        box["loss"] = loss

    for _ in range(steps - 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        step_s.append(start.elapsed_time(end) / 1e3)
        losses.append(float(box["loss"]))
    prof = device_breakdown(step)
    losses.append(float(box["loss"]))
    warm = statistics.median(step_s[1:])
    tiles = runner.tiles
    row = dict(model="gcn3", width=width, graph=g.name, vertices=g.n_vertices,
               edges=g.n_edges, tiles=tiles.n_tiles, s_max=tiles.s_max,
               e_max=tiles.e_max, params=sum(p.numel() for p in params.values()),
               steps=steps, losses=losses, init_s=init_s, step_s=step_s,
               first_step_s=step_s[0], warm_step_s=warm,
               vertex_epochs_per_s=g.n_vertices / warm,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               device_busy_share=None if prof is None else prof["device_ms"] / 1e3 / warm,
               profile=prof)
    emit(dict(phase="gnn_training", **row))
    require(all(v == v and abs(v) != float("inf") for v in losses),
            f"GNN training on {g.name}: losses {losses}")
    require(statistics.mean(losses[-5:]) < statistics.mean(losses[-10:-5]),
            f"GNN training on {g.name}: losses do not fall: {losses}")
    del runner, params, inputs, labels, box
    torch.cuda.empty_cache()
    return row


def gnn_kernel_and_sharded_checks(g, dev, *, width=WIDTH, n_shards=4):
    """On 8 x 8 tiles of ``g`` (where padded edge slots of the scan path
    read rows without an edge): 2-layer gat's and gcn's gradients through
    the scan path and through ``ShardedRunner`` over ``n_shards`` logical
    shards of ``dev`` against ``run_reference``'s; 1-layer gin with kernel
    dispatch on COO and CSR tiles (its SpMM reads only the input) against
    the scan path, then one ``gnn_train_step`` each, the SpMM kernel
    launching in it; 1-layer gcn and gat with kernel dispatch must refuse
    a gradient.  Returns the tile kernels' launches by layout."""
    import numpy as np
    import torch
    from repro_torch.core import compiler
    from repro_torch.core.executor import run_reference
    from repro_torch.core.pipeline import PipelinedRunner, ShardedRunner
    from repro_torch.core.tiling import grid_tile
    from repro_torch.gnn import models as M
    from repro_torch.kernels.tile_spmm import kernel as K
    from repro_torch.launch.train_gnn import gnn_train_step
    from repro_torch.optim.adamw import adamw_init

    tiles = {layout: grid_tile(g, 8, 8, sparse=True, layout=layout)
             for layout in ("coo", "csr")}
    labels = torch.as_tensor(np.random.default_rng(0).integers(0, width, g.n_vertices),
                             device=dev)

    def problem(tr):
        return (_fresh({k: torch.as_tensor(v, device=dev)
                        for k, v in M.init_params(tr, seed=0).items()}),
                {k: torch.as_tensor(v, device=dev)
                 for k, v in M.init_inputs(tr, g, seed=0).items()})

    rows = {}
    for name in ("gat", "gcn"):
        tr = M.trace_stacked(name, 2, width, width, width)
        c = compiler.compile_gnn(tr)
        params, inputs = problem(tr)
        _, want = _gnn_grads(lambda i, p: run_reference(tr, g, i, p, device=dev),
                             inputs, labels, params)
        for label, run in (
                ("scan", PipelinedRunner(c, g, tiles["coo"], kernel_dispatch=False,
                                         device=dev)),
                (f"sharded_{n_shards}", ShardedRunner(
                    c, g, tiles["coo"], n_shards, kernel_dispatch=False,
                    devices=[dev] * n_shards, device=dev))):
            _, got = _gnn_grads(run, inputs, labels, params)
            rows[f"{name}_x2/{label}"] = _grad_err_over_limit(got, want)

    launches = {}
    tr = M.trace_named("gin", width, width)
    c = compiler.compile_gnn(tr)
    for layout, ts in tiles.items():
        params, inputs = problem(tr)
        kernel = PipelinedRunner(c, g, ts, kernel_dispatch=True, device=dev)
        scan = PipelinedRunner(c, g, ts, kernel_dispatch=False, device=dev)
        _, want = _gnn_grads(scan, inputs, labels, params)
        _, got = _gnn_grads(kernel, inputs, labels, params)
        rows[f"gin/kernels_{layout}"] = _grad_err_over_limit(got, want)
        K.reset_launches()
        loss, _, _ = gnn_train_step(kernel, inputs, labels, params, adamw_init(params))
        torch.cuda.synchronize()
        launches[layout] = dict(K.LAUNCHES)
        require(loss == loss, f"gin step with kernels on {layout} tiles: loss {loss}")
    refused = {}
    for name in ("gcn", "gat"):
        tr = M.trace_named(name, width, width)
        params, inputs = problem(tr)
        kernel = PipelinedRunner(compiler.compile_gnn(tr), g, tiles["coo"],
                                 kernel_dispatch=True, device=dev)
        try:
            _gnn_grads(kernel, inputs, labels, params)
            refused[name] = False
        except NotImplementedError:
            refused[name] = True
    emit(dict(phase="gnn_training_checks", graph=g.name, tiles=tiles["coo"].n_tiles,
              width=width, grad_err_over_limit=rows, tol=GNN_GRAD_TOL,
              launches=launches, kernel_dispatch_refused=refused))
    require(all(v <= 1.0 for v in rows.values()), f"GNN gradients: {rows}")
    require(launches["coo"]["tile_spmm"] > 0 and launches["csr"]["tile_spmm_csr"] > 0,
            f"the SpMM kernels were not launched training gin: {launches}")
    require(all(refused.values()), f"a kernel-dispatched gradient was not refused: {refused}")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 14: the mesh across processes (one NCCL rank) and expert-parallel MoE
# ---------------------------------------------------------------------------

def process_group_phase(whole, whole_tiles, grad_cfg, dev, *, width=WIDTH,
                        repeats=3):
    """One ``torch.distributed`` rank (NCCL on the card, gloo on the CPU)
    with a ``FileStore`` under ``build/``: 2-layer gcn and gat on the whole
    graph's tiles through ``ShardMesh.from_process_group()`` against the
    one-process single-shard run, bit for bit, and its exchanges against
    the census; every collective of the group backend (fp8 ``all_to_all``
    included) against the one-process mesh's answer; ``grad_cfg``'s MoE
    layer (full width, a 1 x 512 input) through the group mesh against the
    one-process (1, 1) mesh, bit for bit (``combine`` is a fixed-order
    sum since ROADMAP C.8's repair); then ``compressed_psum`` over the rank's axis, a leaf at
    a time, on gradients shaped like ``grad_cfg``'s parameters in their
    dtype, against ``dequantize(quantize(g))`` and its residual, bit for
    bit.  One rank says nothing about scaling.  Returns the tile kernels'
    launches of the group runs."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import compiler
    from repro_torch.core.analysis import exchange_census
    from repro_torch.core.exchange import ShardMesh
    from repro_torch.core.pipeline import ShardedRunner
    from repro_torch.distributed.compression import (compressed_psum, dequantize_grads,
                                                     quantize_grads)
    from repro_torch.gnn import models as M
    from repro_torch.kernels.moe_dispatch import kernel as GK
    from repro_torch.kernels.tile_spmm import kernel as K
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    from repro_torch.models.common import materialize, torch_dtype, tree_items

    if dev.type == "cuda":                  # NCCL binds the rank to one card
        dev = torch.device("cuda", torch.cuda.current_device())
    store = ROOT / "build" / "pg_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    t0 = time.perf_counter()
    dist.init_process_group(backend, store=dist.FileStore(str(store), 1), rank=0,
                            world_size=1,
                            **({"device_id": dev} if dev.type == "cuda" else {}))
    launches = {}
    try:
        mesh = ShardMesh.from_process_group(device=dev)
        # a collective through the backend before any timing: NCCL sets up
        # its communicator on the first call
        mesh.psum([torch.ones(1, device=dev)], "shards")
        init_s = time.perf_counter() - t0
        for name in ("gcn", "gat"):
            tr = M.trace_stacked(name, 2, width, width, width)
            c = compiler.compile_gnn(tr)
            params = M.init_params(tr, seed=0)
            inputs = M.init_inputs(tr, whole, seed=0)
            census = exchange_census(c.schedule(True)).n_collectives
            one = ShardedRunner(c, whole, whole_tiles, 1, mode="mincut",
                                devices=[dev], device=dev)
            with torch.no_grad():
                (want,), one_s = _timed(lambda: one(inputs, params), dev, repeats)
                mesh.collectives = 0
                group = ShardedRunner(c, whole, whole_tiles, mode="mincut", mesh=mesh)
                before = dict(K.LAUNCHES)
                (got,), group_s = _timed(lambda: group(inputs, params), dev, repeats)
                for k_, n in K.LAUNCHES.items():
                    launches[k_] = launches.get(k_, 0) + n - before[k_]
            per_pass = mesh.collectives / repeats
            emit(dict(phase="process_group_sharded", backend=backend, world_size=1,
                      model=f"{name}_x2", graph=whole.name, layout=whole_tiles.layout,
                      bit_equal=bool(torch.equal(got, want)), exchanges_per_pass=per_pass,
                      census=census, group_warm_s=statistics.median(group_s[1:]),
                      group_runs_s=group_s, one_process_warm_s=statistics.median(one_s[1:]),
                      one_process_runs_s=one_s, init_s=init_s))
            require(torch.equal(got, want),
                    f"process-group {name}: output differs from the one-process run")
            require(per_pass == census,
                    f"process-group {name}: {per_pass} exchanges a pass, census {census}")
            del one, group, got, want
        # each collective on the group against the one-process mesh
        one = ShardMesh([dev], 1)
        gen = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(1, 6, 8, generator=gen, device=dev)
        calls = {"all_gather": lambda m: m.all_gather([x.reshape(-1)]),
                 "all_to_all": lambda m: m.all_to_all([x], "data"),
                 "all_to_all_fp8": lambda m: m.all_to_all(
                     [x.to(torch.float8_e4m3fn)], "data"),
                 "psum": lambda m: m.psum([x], "model"),
                 "pmean": lambda m: m.pmean([x], "shards"),
                 "psum_scatter": lambda m: m.psum_scatter([x], "model", 2),
                 "all_gather_axis": lambda m: m.all_gather_axis([x], "data", 1)}
        unequal = [name for name, call in calls.items()
                   if not torch.equal(call(mesh)[0].float(), call(one)[0].float())]
        # grad_cfg's MoE layer through the group mesh
        p = materialize(gen, MOE.moe_template(grad_cfg), device=dev)
        hx = torch.randn(1, 512, grad_cfg.d_model, generator=gen,
                         device=dev).to(p["wg"].dtype)
        ffn0 = GK.LAUNCHES["grouped_ffn"]
        with torch.no_grad():
            mesh.collectives = 0
            (y_g, aux_g), moe_s = _timed(lambda: MOE.moe_layer(grad_cfg, p, hx, mesh=mesh),
                                         dev, 1)
            moe_collectives = mesh.collectives
            moe_launches = GK.LAUNCHES["grouped_ffn"] - ffn0
            y_1, aux_1 = MOE.moe_layer(grad_cfg, p, hx, mesh=one)
        moe_equal = bool(torch.equal(y_g, y_1) and torch.equal(aux_g, aux_1))
        emit(dict(phase="process_group_collectives", backend=backend, world_size=1,
                  unequal=unequal, moe=grad_cfg.name, moe_tokens=512,
                  moe_bit_equal=moe_equal, moe_s=moe_s[0],
                  moe_collectives=moe_collectives, moe_grouped_ffn_launches=moe_launches))
        require(not unequal, f"group collectives differ from one process: {unequal}")
        require(moe_equal, "the MoE layer through the group mesh differs from (1, 1)")
        require(moe_launches > 0, "the grouped FFN did not launch on the group mesh")
        del p, hx, y_g, y_1
        # compressed_psum on grad_cfg's parameter shapes, a leaf at a time
        mesh.collectives = 0
        n_el, n_leaves, cp_s, worst = 0, 0, 0.0, []
        for path, leaf in tree_items(lm.model_template(grad_cfg)):
            g = {"g": (torch.randn(leaf.shape, generator=gen, device=dev) * 1e-3)
                 .to(torch_dtype(leaf.dtype))}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (mean,), (res,) = compressed_psum([g], mesh, "shards")
            torch.cuda.synchronize()
            cp_s += time.perf_counter() - t0
            q, sc, want_res = quantize_grads(g)
            if not (torch.equal(mean["g"], dequantize_grads(q, sc)["g"])
                    and torch.equal(res["g"], want_res["g"])):
                worst.append("/".join(path))
            n_el += g["g"].numel()
            n_leaves += 1
            del g, mean, res, q, sc, want_res
        emit(dict(phase="process_group_compressed_psum", backend=backend, world_size=1,
                  model=grad_cfg.name, layers=grad_cfg.n_layers, leaves=n_leaves,
                  elements=n_el, seconds=cp_s, psums=mesh.collectives,
                  mismatched_leaves=worst))
        require(not worst, f"compressed_psum differs from dequantize(quantize(g)): {worst}")
        require(mesh.collectives == n_leaves, "compressed_psum: not one psum a leaf")
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    return launches


EP_MESHES = [((1, 1), "plain"), ((2, 1), "plain"), ((4, 1), "plain"), ((2, 2), "plain"),
             ((2, 2), "moe_rs_combine"), ((2, 2), "moe_fp8_dispatch")]


def expert_parallel_phase(cfg, dev, *, seq=512, repeats=3):
    """``lm.forward(mesh=...)`` of ``cfg`` (deepseek-v2 x2, full width, bf16)
    on a 1 x ``seq`` prefill over (data, model) meshes of logical shards of
    ``dev`` (``EP_MESHES``, both options at 2 x 2): at every mesh the
    grouped-FFN kernel against its plain version on the buckets that mesh
    gives it (``LM_KERNEL_TOL``), finite logits, dropped assignments,
    collectives, flash and grouped-FFN launches a forward, seconds (the
    parameters sharded once a mesh, before the timing) and peak memory;
    then ``mesh=None`` against itself and the (1, 1) mesh against
    it, logits and MoE output bit for bit, without deterministic algorithms
    (ROADMAP C.8).  Returns the launches of the meshed forwards."""
    import torch
    from repro_torch import runtime_flags
    from repro_torch.core.exchange import ShardMesh
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.moe_dispatch import kernel as GK
    from repro_torch.kernels.moe_dispatch import ops as moe_ops
    from repro_torch.kernels.moe_dispatch.ref import grouped_ffn_magnitude, grouped_ffn_ref
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    from repro_torch.models.common import join_blocks, materialize, shard_params

    params = materialize(torch.Generator(device=dev).manual_seed(0),
                         lm.model_template(cfg), device=dev)
    tokens = torch.randint(0, cfg.vocab, (1, seq), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    seen = {}
    layer, ffn = MOE.moe_layer, moe_ops.grouped_ffn

    def recording_layer(cfg_, p, x, **kw):
        y, aux = layer(cfg_, p, x, **kw)
        if "layer" not in seen:
            if isinstance(x, list):     # the LM's blocks: one a local rank
                mesh = kw["mesh"]
                x_, y_ = (join_blocks(t, mesh, t[0].device) for t in (x, y))
                p_ = {k: p.blocks[0][k] for k in ("router", "router_bias") if k in p}
                seen["layer"] = (p_, x_, y_)
            else:
                seen["layer"] = (p, x, y)
        return y, aux

    def recording_ffn(*args):
        seen.setdefault("ffn", args)
        return ffn(*args)

    def forward(mesh, p=params):
        seen.clear()
        with torch.no_grad():
            return lm.forward(cfg, p, {"tokens": tokens}, mesh=mesh)

    launches = {"flash_attention": 0, "grouped_ffn": 0}
    tol = LM_KERNEL_TOL["grouped_ffn"]
    MOE.moe_layer, moe_ops.grouped_ffn = recording_layer, recording_ffn
    try:
        for (n_data, n_model), flag in EP_MESHES:
            for key in ("moe_rs_combine", "moe_fp8_dispatch"):
                runtime_flags.OPT[key] = key == flag
            mesh = ShardMesh([dev] * (n_data * n_model), n_data, n_model)
            torch.cuda.reset_peak_memory_stats()
            sp = shard_params(params, lm.model_template(cfg), mesh)
            mesh.collectives = 0
            before = {**FK.LAUNCHES, **GK.LAUNCHES}
            (logits, aux), secs = _timed(lambda: forward(mesh, sp), dev, repeats)
            counts = {k_: (n - before[k_]) / repeats
                      for k_, n in {**FK.LAUNCHES, **GK.LAUNCHES}.items()}
            for k_ in launches:
                launches[k_] += counts[k_] * repeats
            peak = torch.cuda.max_memory_allocated() / 1e9
            p_, x_, _ = seen["layer"]
            b, wg, wu, wd, live = seen["ffn"]
            # the kernel against the plain version on this mesh's buckets
            got = moe_ops._forward(b, wg, wu, wd, live).float()
            want = grouped_ffn_ref(b, wg, wu, wd, live).float()
            limit = (tol[0] + tol[1] * grouped_ffn_magnitude(b, wg, wu, wd, live)
                     + BF16_ULP * want.abs())
            ffn_over = float(((got - want).abs() / limit).max())
            ffn_ms = time_ms(lambda: moe_ops._forward(b, wg, wu, wd, live), 5, 1)
            del got, want, limit
            row = dict(phase="expert_parallel", model=cfg.name, layers=cfg.n_layers,
                       dtype=str(params["embed"].dtype).replace("torch.", ""),
                       tokens=seq, mesh=[n_data, n_model], option=flag,
                       devices=[str(d) for d in mesh.devices],
                       warm_s=statistics.median(secs[1:]), runs_s=secs,
                       collectives_per_forward=mesh.collectives / repeats,
                       flash_launches=counts["flash_attention"],
                       grouped_ffn_launches=counts["grouped_ffn"],
                       dropped=MOE.count_dropped(cfg, p_, x_, n_data=n_data),
                       assignments=x_.shape[0] * x_.shape[1] * cfg.moe.top_k,
                       ffn_shape=list(b.shape), ffn_f_local=wg.shape[-1],
                       ffn_kernel_ms=ffn_ms, ffn_err_over_limit=ffn_over,
                       aux=float(aux), peak_mem_gb=peak,
                       logits_finite=bool(torch.isfinite(logits).all()))
            emit(row)
            require(row["logits_finite"] and tuple(logits.shape) == (1, seq, cfg.vocab),
                    f"expert-parallel {n_data}x{n_model} {flag}: logits")
            require(ffn_over <= 1, f"expert-parallel {n_data}x{n_model} {flag}: the grouped "
                    f"FFN kernel at {ffn_over} x its limit")
            require(counts["grouped_ffn"] > 0 and counts["flash_attention"] > 0,
                    f"expert-parallel {n_data}x{n_model} {flag}: a kernel did not launch")
            del logits, seen["ffn"], seen["layer"], b, wg, wu, wd, p_, x_, sp
            torch.cuda.empty_cache()
        for key in ("moe_rs_combine", "moe_fp8_dispatch"):
            runtime_flags.OPT[key] = False
        # mesh=None against itself, then (1, 1) against it, bit for bit
        # (ROADMAP C.8: ``combine`` is a fixed-order sum)
        outs = {}
        for label, mesh in (("none", None), ("none_again", None),
                            ("one", ShardMesh([dev], 1, 1))):
            logits, _ = forward(mesh)
            outs[label] = (logits, seen["layer"][2])
        same = {k: dict(logits=bool(torch.equal(outs["none"][0], outs[k][0])),
                        moe=bool(torch.equal(outs["none"][1], outs[k][1])))
                for k in ("none_again", "one")}
        emit(dict(phase="expert_parallel_vs_no_mesh", model=cfg.name,
                  none_run_to_run_bit_equal=same["none_again"],
                  one_by_one_bit_equal=same["one"]))
        require(all(all(v.values()) for v in same.values()),
                f"expert-parallel: mesh=None run to run or (1, 1) against it: {same}")
    finally:
        MOE.moe_layer, moe_ops.grouped_ffn = layer, ffn
        for key in ("moe_rs_combine", "moe_fp8_dispatch"):
            runtime_flags.OPT[key] = False
    del params, outs
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 15: the LM sharded by its specs, over logical ranks of the card
# ---------------------------------------------------------------------------

TP_MESHES = ((1, 4), (2, 2))
TP_SERVE = dict(requests=8, batch=4, max_prompt=24, max_new=16)     # phase 7's load
TP_CHECK_LEN = 8                # decode vs forward, as phase 7
TP_TRAIN_SHAPE = (4, 1024)      # phase 12's qwen2-1.5b batch
TP_SMOLLM_SHAPE = (8, 512)


def _bf16_limit(cfg, params, batch, ref):
    """Phase 7's bf16 rule for two bf16 runs of one model: 3 x e_model (the
    bf16 forward's distance from the fp32 forward on the same weights) + the
    family's fp32 limit; returns (limit, e_model)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    with torch.no_grad():
        out = lm.forward(cfg, tree_map(lambda t: t.float(), params), batch)
    e_model = scaled_err(ref.float(), out[0] if cfg.family == "moe" else out)
    del out
    torch.cuda.empty_cache()
    return BF16_MODEL_MULTIPLE * e_model + LM_MODEL_TOL[cfg.family], e_model


def _rank_bytes(sp):
    """Local rank 0's parameter bytes against the whole tree's, all leaves
    and the leaves split over model (tensor parallel)."""
    import math
    from repro_torch.models.common import model_sharded, torch_dtype, tree_items
    mine = whole = tp_mine = tp_whole = 0
    for (_, l), (_, spec), (_, t) in zip(tree_items(sp.template), tree_items(sp.specs),
                                         tree_items(sp.blocks[0])):
        w = math.prod(l.shape) * t.element_size()
        b = t.numel() * t.element_size()
        mine, whole = mine + b, whole + w
        if any(model_sharded(e) for e in spec):
            tp_mine, tp_whole = tp_mine + b, tp_whole + w
    return dict(rank0_gb=mine / 1e9, whole_gb=whole / 1e9,
                tp_leaves_share=tp_mine / max(1, tp_whole))


def dense_collectives(cfg, mesh) -> int:
    """The collectives of a dense forward reckoned from its layers: per layer
    one all-gather over model for each of q / k / v whose heads do not divide
    the axis but whose columns do (they split mid-head), the psums after
    ``wo`` and ``wd``; then the vocabulary-parallel lookup's psum and the
    logits' all-gather."""
    M = mesh.model_axis
    per_layer = 2 + sum(1 for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)
                        if n % M and (n * cfg.hdim) % M == 0)
    return cfg.n_layers * per_layer + 2


def family_collectives(cfg, mesh) -> int:
    """The collectives of one forward of the audio, ssm or hybrid family,
    reckoned from the widths of its layers over a model axis of M (a
    gather runs only where M > 1 splits a width a rank reads whole, a psum
    over model wherever a row-parallel weight's rows are laid out over it):

    * attention (whisper's self and cross, zamba2's shared block): an
      all-gather for each of q / k / v whose heads do not divide M but
      whose columns do, the psum after ``wo`` where its rows divide M; an
      MLP: the psum after its
      down projection where its width divides M;
    * mLSTM: gathers of the up projection (2 di), ``conv_w``, ``conv_b``,
      ``wq`` / ``wk`` / ``wv`` and ``norm_w`` (when the heads do not divide M),
      ``w_if`` and ``b_if`` (their [i | f] columns), the norm's psum (heads
      split), the psum after ``w_down``;
    * sLSTM: gathers of ``w_x`` and ``b`` (heads not dividing M), ``r_h``,
      the normed output (heads split), the norm's psum (heads split), the
      GeGLU's psum where its width divides M;
    * Mamba2: gathers of ``w_in``'s projection, ``conv_w``, ``conv_b`` and
      ``norm_w`` (heads not dividing M), the norm's psum (heads split), the
      psum after ``w_out``;
    * the vocabulary-parallel lookup's psum and the logits' all-gather,
      where the vocabulary divides M."""
    M = mesh.model_axis

    def split(n):                    # a gather of a width n that M splits
        return int(M > 1 and n % M == 0)

    def attention():
        return int(cfg.n_heads * cfg.hdim % M == 0) + sum(
            1 for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)
            if n % M and (n * cfg.hdim) % M == 0)

    vocab = 2 * int(cfg.vocab % M == 0)
    if cfg.family == "audio":
        ffn = int(cfg.d_ff % M == 0)
        return (cfg.n_encoder_layers * (attention() + ffn)
                + cfg.n_layers * (2 * attention() + ffn) + vocab)
    if cfg.family == "ssm":
        d, nh, k = cfg.d_model, cfg.n_heads, cfg.xlstm.slstm_every
        di = int(d * cfg.xlstm.proj_factor)
        mh = int(M > 1 and nh % M == 0)
        mlstm = (split(2 * di) + 2 * split(di) + 4 * (1 - mh) * split(di)
                 + 2 * split(2 * nh) + mh + int(di % M == 0))
        dff = int(d * 4 / 3)
        slstm = (2 * (1 - mh) * split(4 * d) + split(4 * d // nh) + 2 * mh
                 + int(dff % M == 0))
        return cfg.n_layers // k * ((k - 1) * mlstm + slstm) + vocab
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    mh = int(M > 1 and nh % M == 0)
    conv_ch = di + 2 * s.n_groups * s.d_state
    mamba = (split(2 * di + 2 * s.n_groups * s.d_state + nh) + 2 * split(conv_ch)
             + (1 - mh) * split(di) + mh + int(di % M == 0))
    shared = attention() + int(cfg.d_ff % M == 0)
    return (cfg.n_layers // cfg.shared_attn_every
            * (cfg.shared_attn_every * mamba + shared) + vocab)


def _mesh_decode_err(cfg, sp, mesh, dev, full, tokens, fill=None):
    """Teacher-forced decode through ``make_decode_step(cfg, mesh)`` on a
    sharded cache (``fill(cache)`` first, where given) against ``full``,
    the mesh forward's logits of the same tokens; the worst step's scaled
    error."""
    import torch
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import lm
    cache = lm.init_cache(cfg, tokens.shape[0], tokens.shape[1], mesh=mesh)
    if fill is not None:
        fill(cache)
    step = make_decode_step(cfg, mesh)
    err = 0.0
    for pos in range(tokens.shape[1]):
        logits, cache = step(sp, cache, tokens[:, pos:pos + 1], pos)
        require(bool(torch.isfinite(logits).all()), f"{cfg.name}: non-finite mesh decode")
        err = max(err, scaled_err(logits.float(), full[:, pos].float()))
    return err


class MeshCalls:
    """Phase 15's meshed calls.  :meth:`run` calls ``fn`` and adds the
    kernel launches it makes to ``launches[label]`` (a delta around the
    call, so neither the ``mesh=None`` baselines beside it nor the kernel
    checks are counted), keeping the inputs of the last flash and
    grouped-FFN call of each shape and option it makes (a decode's last
    step reads the fullest cache; a cache is written only past the
    ``kv_len`` of the steps before, so the inputs are kept without a
    copy); :meth:`check` then holds each kernel against its plain version
    on them."""

    def __init__(self):
        self.launches = {}
        self.inputs = {}

    def run(self, label, fn):
        from repro_torch.kernels.flash_attention import kernel as FK
        from repro_torch.kernels.moe_dispatch import kernel as GK
        from repro_torch.kernels.moe_dispatch import ops as moe_ops
        from repro_torch.models import attention
        flash, ffn = attention.flash_attention, moe_ops.grouped_ffn

        def recording_flash(q, k, v, **opts):
            key = (label, "flash_attention", tuple(q.shape), tuple(k.shape), tuple(v.shape),
                   str(q.dtype), opts.get("causal", True), opts.get("window"),
                   opts.get("kv_len") is None)
            self.inputs[key] = ([t.detach() for t in (q, k, v)], opts)
            return flash(q, k, v, **opts)

        def recording_ffn(*args):
            key = (label, "grouped_ffn", *(tuple(t.shape) for t in args), str(args[0].dtype))
            self.inputs[key] = ([t.detach() for t in args], {})
            return ffn(*args)

        before = {**FK.LAUNCHES, **GK.LAUNCHES}
        attention.flash_attention, moe_ops.grouped_ffn = recording_flash, recording_ffn
        try:
            return fn()
        finally:
            attention.flash_attention, moe_ops.grouped_ffn = flash, ffn
            mine = self.launches.setdefault(label, dict.fromkeys(before, 0))
            for k_, n in {**FK.LAUNCHES, **GK.LAUNCHES}.items():
                mine[k_] += n - before[k_]

    def by_cell(self):
        """The launches summed over each cell (a label's first word)."""
        out = {}
        for label, counts in self.launches.items():
            cell = out.setdefault(label.split()[0], dict.fromkeys(counts, 0))
            for k_, n in counts.items():
                cell[k_] += n
        return out

    def check(self):
        """Each kept call's kernel against its plain version on the same
        inputs, at ``LM_KERNEL_TOL`` (+ one bf16 ulp of the plain output in
        bf16), as phase 6 holds them: one line a call, failing on any over
        its limit or not finite."""
        import torch
        from repro_torch.kernels.flash_attention import kernel as FK
        from repro_torch.kernels.flash_attention.ref import flash_attention_ref
        from repro_torch.kernels.moe_dispatch import ops as moe_ops
        from repro_torch.kernels.moe_dispatch.ref import grouped_ffn_magnitude, grouped_ffn_ref
        failed = []
        for key, (args, opts) in self.inputs.items():
            label, name = key[:2]
            if name == "flash_attention":
                q, k, v = (t.contiguous() for t in args)
                o = {n: opts[n] for n in ("causal", "window", "kv_len") if n in opts}
                if o.get("kv_len") is not None:
                    o["kv_len"] = o["kv_len"].to(torch.int32)
                got = FK.flash_attention_cuda(q, k, v, **o).float()
                want = flash_attention_ref(q, k, v, **o).float()
                mag = flash_attention_ref(q, k, v.abs(), **o).float()
                shapes = dict(q=list(q.shape), k=list(k.shape), v=list(v.shape),
                              causal=o.get("causal", True), window=o.get("window"),
                              kv_len=None if o.get("kv_len") is None
                              else o["kv_len"].tolist())
            else:
                got = moe_ops._forward(*args).float()
                want = grouped_ffn_ref(*args).float()
                mag = grouped_ffn_magnitude(*args).float()
                shapes = dict(buckets=list(args[0].shape), wg=list(args[1].shape),
                              live=args[4].tolist())
            tol = LM_KERNEL_TOL[name]
            limit = tol[0] + tol[1] * mag
            if args[0].dtype == torch.bfloat16:
                limit = limit + BF16_ULP * want.abs()
            err = (got - want).abs()
            row = dict(phase="tp_kernel_check", kernel=name, call=label,
                       dtype=str(args[0].dtype).replace("torch.", ""), shapes=shapes,
                       max_abs_err=float(err.max()), err_over_limit=float((err / limit).max()),
                       finite=bool(torch.isfinite(got).all()))
            emit(row)
            if not (row["finite"] and row["err_over_limit"] <= 1):
                failed.append(f"{name} {label} {shapes}: {row['err_over_limit']} x its limit")
            del got, want, mag, err, limit
        self.inputs.clear()
        torch.cuda.empty_cache()
        require(not failed, "tp kernel checks: " + "; ".join(failed))


def _spread(step_s):
    """Decode step seconds: p10, p50 and p90."""
    d = statistics.quantiles(step_s, n=10)
    return dict(decode_step_p10_s=d[0], decode_step_p50_s=statistics.median(step_s),
                decode_step_p90_s=d[8], decode_steps=len(step_s))


def tp_dense_phase(cfg, dev, calls, *, prefill_len=PREFILL_LEN, repeats=3):
    """15a: ``cfg`` (qwen2-1.5b, bf16, every layer) over ``TP_MESHES``: a 1 x
    ``prefill_len`` forward against ``mesh=None`` at phase 7's bf16 limit,
    collectives a forward against :func:`dense_collectives`, rank 0's
    parameter bytes, ``serve_requests`` on the sharded KV cache at phase
    7's load (decode step p10 / p50 / p90), teacher-forced decode against
    the mesh forward, warm forward s, peak memory; then the fp32 2-layer
    cut at phase 12's batch against ``mesh=None`` at ``TRAIN_PARITY_TOL``.
    The meshed calls go through ``calls`` (:class:`MeshCalls`)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.exchange import ShardMesh
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import lm
    from repro_torch.models.common import materialize, shard_params

    params = materialize(torch.Generator(device=dev).manual_seed(0),
                         lm.model_template(cfg), device=dev)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab, (1, prefill_len)),
                             device=dev)
    with torch.no_grad():
        ref = lm.forward(cfg, params, {"tokens": tokens})
    limit, e_model = _bf16_limit(cfg, params, {"tokens": tokens}, ref)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, TP_SERVE["max_prompt"] + 1))
               for _ in range(TP_SERVE["requests"])]
    for shape in TP_MESHES:
        tag = f"15a {shape[0]}x{shape[1]}"
        mesh = ShardMesh([dev] * (shape[0] * shape[1]), *shape)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sp = shard_params(params, lm.model_template(cfg), mesh)
        mesh.collectives = 0
        with torch.no_grad():
            logits, secs = calls.run(tag, lambda: _timed(
                lambda: lm.forward(cfg, sp, {"tokens": tokens}, mesh=mesh), dev, repeats))
        per_forward = mesh.collectives / repeats
        err = scaled_err(logits.float(), ref.float())
        peak = torch.cuda.max_memory_allocated() / 1e9
        with torch.no_grad():
            full = calls.run(tag, lambda: lm.forward(
                cfg, sp, {"tokens": tokens[:, :TP_CHECK_LEN]}, mesh=mesh))
        dec = calls.run(tag, lambda: _mesh_decode_err(cfg, sp, mesh, dev, full,
                                                      tokens[:, :TP_CHECK_LEN]))
        res = calls.run(tag, lambda: serve_requests(
            cfg, sp, prompts, batch=TP_SERVE["batch"], max_prompt=TP_SERVE["max_prompt"],
            max_new=TP_SERVE["max_new"], device=dev, mesh=mesh))
        toks = np.concatenate([o.ravel() for o in res["tokens"]])
        row = dict(phase="tp_dense", model=cfg.name, layers=cfg.n_layers, dtype="bfloat16",
                   mesh=list(shape), tokens=prefill_len, **_rank_bytes(sp),
                   collectives_per_forward=per_forward,
                   collectives_reckoned=dense_collectives(cfg, mesh),
                   vs_no_mesh_err=err, limit=limit, bf16_vs_fp32_forward_err=e_model,
                   decode_vs_forward_err=dec, warm_forward_s=statistics.median(secs[1:]),
                   forward_runs_s=secs, serve=TP_SERVE, serve_tokens_per_s=res["tokens_per_s"],
                   **_spread(res["step_s"]), peak_mem_gb=peak,
                   note="logical ranks of one card: measures no scaling")
        emit(row)
        require(per_forward == row["collectives_reckoned"],
                f"tp {cfg.name} {shape}: {per_forward} collectives a forward, reckoned "
                f"{row['collectives_reckoned']}")
        require(err <= limit and dec <= limit,
                f"tp {cfg.name} {shape}: vs mesh=None {err}, decode {dec}, limit {limit}")
        require(toks.size == TP_SERVE["requests"] * TP_SERVE["max_new"]
                and toks.min() >= 0 and toks.max() < cfg.vocab,
                f"tp {cfg.name} {shape}: bad served tokens")
        del sp, logits, full
    del params, ref
    torch.cuda.empty_cache()
    # the fp32 cut at phase 12's width and batch
    cut = dataclasses.replace(cfg, n_layers=2)
    p32 = materialize(torch.Generator(device=dev).manual_seed(0), lm.model_template(cut),
                      dtype_override="float32", device=dev)
    b = {"tokens": torch.as_tensor(np.random.default_rng(5).integers(
        0, cut.vocab, TP_TRAIN_SHAPE), device=dev)}
    with torch.no_grad():
        want = lm.forward(cut, p32, b)
        errs = {f"{s[0]}x{s[1]}": scaled_err(calls.run(f"15a {s[0]}x{s[1]} fp32", lambda: (
            lm.forward(cut, p32, b, mesh=ShardMesh([dev] * (s[0] * s[1]), *s)))), want)
            for s in TP_MESHES}
    emit(dict(phase="tp_dense_fp32_cut", model=cut.name, layers=2, batch=list(TP_TRAIN_SHAPE),
              err=errs, tol=TRAIN_PARITY_TOL))
    require(all(e <= TRAIN_PARITY_TOL for e in errs.values()),
            f"tp fp32 cut vs mesh=None: {errs}")
    del p32, want
    torch.cuda.empty_cache()


def tp_heads_phase(cfg, dev, calls, *, shape=(2, 4), batch=TP_SMOLLM_SHAPE, repeats=3):
    """15b: ``cfg`` (smollm-135m, bf16, every layer: 9 heads on a 4-wide
    model axis) at ``shape``, ``OPT["attn_batch_shard"]`` off (heads
    gathered, attention replicated over model) and on (the batch over every
    axis), both against ``mesh=None`` at phase 7's bf16 limit."""
    import numpy as np
    import torch
    from repro_torch import runtime_flags
    from repro_torch.core.exchange import ShardMesh
    from repro_torch.models import attention, lm
    from repro_torch.models.common import materialize, shard_params

    params = materialize(torch.Generator(device=dev).manual_seed(0),
                         lm.model_template(cfg), device=dev)
    b = {"tokens": torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab, batch),
                                   device=dev)}
    with torch.no_grad():
        ref = lm.forward(cfg, params, b)
    limit, e_model = _bf16_limit(cfg, params, b, ref)
    mesh = ShardMesh([dev] * (shape[0] * shape[1]), *shape)
    sp = shard_params(params, lm.model_template(cfg), mesh)
    seen = []
    to_batch = attention._columns_to_batch
    attention._columns_to_batch = lambda *a: (seen.append(1), to_batch(*a))[1]
    try:
        for flag in (False, True):
            runtime_flags.OPT["attn_batch_shard"] = flag
            seen.clear()
            mesh.collectives = 0
            with torch.no_grad():
                out, secs = calls.run(f"15b attn_batch_shard={flag}", lambda: _timed(
                    lambda: lm.forward(cfg, sp, b, mesh=mesh), dev, repeats))
            err = scaled_err(out.float(), ref.float())
            row = dict(phase="tp_heads", model=cfg.name, layers=cfg.n_layers,
                       heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, mesh=list(shape),
                       batch=list(batch), attn_batch_shard=flag,
                       batch_split_calls=len(seen) // repeats,
                       collectives_per_forward=mesh.collectives / repeats,
                       vs_no_mesh_err=err, limit=limit, bf16_vs_fp32_forward_err=e_model,
                       warm_forward_s=statistics.median(secs[1:]), forward_runs_s=secs)
            emit(row)
            require(err <= limit, f"tp {cfg.name} attn_batch_shard={flag}: {err} over {limit}")
            require((len(seen) > 0) == flag,
                    f"tp {cfg.name}: the batch-split attention ran {len(seen)} times "
                    f"with attn_batch_shard={flag}")
    finally:
        runtime_flags.OPT["attn_batch_shard"] = False
        attention._columns_to_batch = to_batch
    del params, sp, ref, out
    torch.cuda.empty_cache()


def tp_moe_phase(cfg, dev, calls, *, shape=(2, 2), seq=512, repeats=3):
    """15c: ``cfg`` (deepseek-v2 x2, bf16) at ``shape``: tensor-parallel MLA,
    the expert-parallel MoE, the tensor-parallel shared experts and dense
    layer.  A 1 x ``seq`` forward against ``mesh=None`` routing the same
    token blocks (a mesh of n_data shards routes 4 x n_data blocks of
    seq / (4 n_data) tokens, so the reference run takes 4 x n_data chunks)
    at phase 7's bf16 limit, without deterministic algorithms (ROADMAP
    C.8: ``mesh=None`` twice bit for bit); the absorbed decode on the
    sequence-sharded latent cache against the mesh forward; peak memory."""
    import numpy as np
    import torch
    from repro_torch.core.exchange import ShardMesh
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    from repro_torch.models.common import materialize, shard_params

    params = materialize(torch.Generator(device=dev).manual_seed(0),
                         lm.model_template(cfg), device=dev)
    b = {"tokens": torch.as_tensor(np.random.default_rng(7).integers(0, cfg.vocab, (1, seq)),
                                   device=dev)}
    layer = MOE.moe_layer

    def blocks_of(n_data):
        def moe_layer(cfg_, p, x, mesh=None, token_chunks=4):
            return layer(cfg_, p, x, mesh=mesh, token_chunks=token_chunks * n_data)
        return moe_layer

    MOE.moe_layer = blocks_of(shape[0])
    try:
        with torch.no_grad():
            ref = lm.forward(cfg, params, b)[0]
            again = lm.forward(cfg, params, b)[0]
        limit, e_model = _bf16_limit(cfg, params, b, ref)
    finally:
        MOE.moe_layer = layer
    mesh = ShardMesh([dev] * (shape[0] * shape[1]), *shape)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sp = shard_params(params, lm.model_template(cfg), mesh)
    mesh.collectives = 0
    with torch.no_grad():
        (logits, aux), secs = calls.run("15c", lambda: _timed(
            lambda: lm.forward(cfg, sp, b, mesh=mesh), dev, repeats))
        per_forward = mesh.collectives / repeats
        full = calls.run("15c", lambda: lm.forward(
            cfg, sp, {"tokens": b["tokens"][:, :TP_CHECK_LEN]}, mesh=mesh)[0])
    peak = torch.cuda.max_memory_allocated() / 1e9
    dec = calls.run("15c decode", lambda: _mesh_decode_err(cfg, sp, mesh, dev, full,
                                                            b["tokens"][:, :TP_CHECK_LEN]))
    err = scaled_err(logits.float(), ref.float())
    row = dict(phase="tp_moe", model=cfg.name, layers=cfg.n_layers, mesh=list(shape),
               tokens=seq, **_rank_bytes(sp), no_mesh_run_to_run_bit_equal=bool(
                   torch.equal(ref, again)),
               vs_no_mesh_err=err, limit=limit, bf16_vs_fp32_forward_err=e_model,
               decode_vs_forward_err=dec, collectives_per_forward=per_forward,
               warm_forward_s=statistics.median(secs[1:]), forward_runs_s=secs,
               aux=float(aux), peak_mem_gb=peak, phase14b_peak_gb=18.7)
    emit(row)
    require(row["no_mesh_run_to_run_bit_equal"], "mesh=None differs from itself (C.8)")
    require(err <= limit and dec <= limit,
            f"tp-ep {cfg.name}: vs mesh=None {err}, decode {dec}, limit {limit}")
    del params, sp, ref, again, logits, full
    torch.cuda.empty_cache()


def _two_step_parity(cfg, dev, shape, flags, calls, label, *, batch, seq, microbatches):
    """Two fp32 steps of ``cfg`` on ``shape`` under ``flags`` against two
    mesh-less steps, judged as ``training_parity`` judges them; the meshed
    run goes through ``calls`` as ``label``."""
    import torch
    from repro_torch import runtime_flags
    from repro_torch.core.exchange import ShardMesh
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import batch_tensors
    from repro_torch.models import lm
    from repro_torch.models.common import materialize, tree_items, unshard_params
    from repro_torch.optim.adamw import adamw_init

    pipe = TokenPipeline(cfg, seq_len=seq, global_batch=batch)
    data = [batch_tensors(pipe.global_batch_at(i), dev) for i in range(2)]

    def run(mesh, mb):
        p = materialize(torch.Generator(device=dev).manual_seed(0), lm.model_template(cfg),
                        dtype_override="float32", device=dev)
        opt = adamw_init(p)
        step = make_train_step(cfg, mesh, peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                               microbatches=mb)
        ms = []
        for d in data:
            p, opt, m = step(p, opt, d)
            ms.append({k: float(v) for k, v in m.items()})
        if mesh is not None:
            p, opt = unshard_params(p), opt._replace(m=unshard_params(opt.m),
                                                     v=unshard_params(opt.v))
        return p, opt, ms

    pp, op, mp = run(None, 1)
    for k in flags:
        runtime_flags.OPT[k] = True
    try:
        pk, ok, mk = calls.run(label, lambda: run(
            ShardMesh([dev] * (shape[0] * shape[1]), *shape), microbatches))
    finally:
        for k in flags:
            runtime_flags.OPT[k] = False
    rel = {f"{k}_{i}": abs(a[k] - b[k]) / max(1e-30, abs(b[k]))
           for i, (a, b) in enumerate(zip(mk, mp)) for k in ("loss", "grad_norm")}
    moment = max(float((a - b).abs().max()) / max(1e-30, float(b.abs().max()))
                 for tk, tp in ((ok.m, op.m), (ok.v, op.v))
                 for (_, a), (_, b) in zip(tree_items(tk), tree_items(tp)))
    ratio = max(float(((a - b).abs() / _adamw_param_limit(
        b, m, v, mk[1]["lr"], 2, TRAIN_PARITY_TOL)).max())
        for (_, a), (_, b), (_, m), (_, v) in zip(tree_items(pk), tree_items(pp),
                                                  tree_items(op.m), tree_items(op.v)))
    return rel, moment, ratio


def tp_train_phase(cfg, dev, calls, *, shape=(2, 2), steps=2, batch=TP_TRAIN_SHAPE):
    """15d: ``cfg`` (qwen2-1.5b, bf16, every layer) trained ``steps`` steps at
    ``shape`` plain and under ``zero1_opt_state`` + ``fsdp_params`` with 2
    microbatches: losses finite, step s, tokens/s, peak memory, rank 0's
    moment bytes; then the fp32 2-layer cut's two steps against mesh=None's
    (``TRAIN_PARITY_TOL``) under both settings."""
    import dataclasses

    import torch
    from repro_torch import runtime_flags
    from repro_torch.core.exchange import ShardMesh
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.steps import make_train_step, maybe_fsdp
    from repro_torch.launch.train import batch_tensors
    from repro_torch.models import lm
    from repro_torch.models.common import materialize, shard_params, tree_items
    from repro_torch.optim.adamw import adamw_init

    pipe = TokenPipeline(cfg, seq_len=batch[1], global_batch=batch[0])
    settings = (("plain", (), 1), ("zero1+fsdp", ("zero1_opt_state", "fsdp_params"), 2))
    for label, flags, mb in settings:
        for k in flags:
            runtime_flags.OPT[k] = True
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            mesh = ShardMesh([dev] * (shape[0] * shape[1]), *shape)
            p = materialize(torch.Generator(device=dev).manual_seed(0),
                            lm.model_template(cfg), device=dev)
            sp = shard_params(p, maybe_fsdp(lm.model_template(cfg)), mesh)
            del p
            opt = adamw_init(sp)
            step = make_train_step(cfg, mesh, peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                                   microbatches=mb)
            losses, step_s = [], []
            for s in range(steps):
                d = batch_tensors(pipe.global_batch_at(s), dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sp, opt, m = calls.run(f"15d {label}", lambda: step(sp, opt, d))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
            mom = sum(t.numel() * t.element_size() for tree in (opt.m, opt.v)
                      for _, t in tree_items(tree.blocks[0]))
            row = dict(phase="tp_training", model=cfg.name, layers=cfg.n_layers,
                       mesh=list(shape), setting=label, microbatches=mb,
                       batch=list(batch), losses=losses, step_s=step_s,
                       tokens_per_s=batch[0] * batch[1] / step_s[-1],
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                       rank0_moment_gb=mom / 1e9, **_rank_bytes(sp),
                       note="logical ranks of one card: measures no scaling")
            emit(row)
            require(all(v == v and abs(v) != float("inf") for v in losses),
                    f"tp training {label}: losses {losses}")
            del sp, opt, step
        finally:
            for k in flags:
                runtime_flags.OPT[k] = False
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, n_layers=2)
    for label, flags, mb in settings:
        rel, moment, ratio = _two_step_parity(cut, dev, shape, flags, calls,
                                              f"15d {label} fp32", batch=batch[0],
                                              seq=batch[1], microbatches=mb)
        emit(dict(phase="tp_training_parity", model=cut.name, layers=2, mesh=list(shape),
                  setting=label, microbatches=mb, rel_err=rel, moment_err=moment,
                  param_err_over_limit=ratio, tol=TRAIN_PARITY_TOL))
        require(all(v <= TRAIN_PARITY_TOL for v in rel.values()) and moment <= TRAIN_PARITY_TOL
                and ratio <= 1.0, f"tp training parity {label}: {rel} {moment} {ratio}")
    torch.cuda.empty_cache()


def tp_group_phase(cfg, dev, *, batch=(2, 256)):
    """15e: one train step of ``cfg`` (the fp32 2-layer cut) through
    ``ShardMesh.from_process_group()`` on one NCCL rank (gloo on the CPU),
    autograd through the group's collectives, against the one-process (1,
    1) mesh: params, moments, loss and grad norm bit for bit (deterministic
    algorithms on: the embedding's backward scatters).  One rank says
    nothing about scaling."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.exchange import ShardMesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.models.common import materialize, tree_items

    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    b = {"tokens": torch.as_tensor(np.random.default_rng(8).integers(0, cfg.vocab, batch),
                                   device=dev)}

    def one_step(mesh):
        from repro_torch.optim.adamw import adamw_init
        p = materialize(torch.Generator(device=dev).manual_seed(0), lm.model_template(cfg),
                        dtype_override="float32", device=dev)
        step = make_train_step(cfg, mesh, peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS)
        mesh.collectives = 0
        sp, opt, m = step(p, adamw_init(p), b)
        return sp, opt, m, mesh.collectives

    # the embedding's and the loss's backwards scatter with atomics on the
    # card: bit-for-bit training needs the deterministic kernels
    torch.use_deterministic_algorithms(True, warn_only=True)
    store = ROOT / "build" / "pg_store_tp"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(str(store), 1), rank=0,
                            world_size=1,
                            **({"device_id": dev} if dev.type == "cuda" else {}))
    try:
        try:
            got = one_step(ShardMesh.from_process_group(device=dev))
        finally:
            dist.destroy_process_group()
            store.unlink(missing_ok=True)
        want = one_step(ShardMesh([dev], 1, 1))
    finally:
        torch.use_deterministic_algorithms(False)
    equal = all(torch.equal(a, c) for tg, tw in ((got[0].blocks[0], want[0].blocks[0]),
                                                 (got[1].m.blocks[0], want[1].m.blocks[0]),
                                                 (got[1].v.blocks[0], want[1].v.blocks[0]))
                for (_, a), (_, c) in zip(tree_items(tg), tree_items(tw)))
    equal = equal and all(torch.equal(got[2][k], want[2][k]) for k in ("loss", "grad_norm"))
    emit(dict(phase="tp_group_training", backend=backend, world_size=1, model=cfg.name,
              layers=cfg.n_layers, batch=list(batch), bit_equal=equal,
              group_collectives=got[3], one_process_collectives=want[3],
              loss=float(got[2]["loss"]),
              note="one rank: checks the group path, measures no scaling"))
    require(equal, "the train step through the group mesh differs from one process")
    require(got[3] > want[3], "no collective ran in the group step's backward")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 16: the recurrent and encoder-decoder families on a mesh
# ---------------------------------------------------------------------------

FAMILY_MESHES = (((1, 4), 1), ((2, 2), 2))     # (mesh, prefill batch)
FAMILY_PREFILL = {"audio": WHISPER_DECODER_LEN, "ssm": XLSTM_PREFILL_LEN,
                  "hybrid": PREFILL_LEN}
FAMILY_TRAIN = (2, 256)                          # the fp32 cuts' (batch, seq)
# the 8-bit step: mesh, tokens a row (fp32 deepseek-v2 x2 on 4 logical
# ranks holds ~70 GB before its activations)
Q8_SHAPE, Q8_SEQ = (2, 2), 128


def fill_cross_sharded(cfg, params, sp, cache, frames):
    """:func:`fill_cross_cache` for a sharded cache: the encoder on the mesh
    (``sp``, the sharded ``params``), the whole cross K/V projected from its
    output with ``params``' weights, then each rank's block of it."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.common import shard_params
    sub = cache.sub("cross")
    enc = lm.encode(cfg, sp, frames, mesh=cache.mesh)
    B, T, _ = enc.shape
    xa = params["layers"]["xattn"]
    whole = {}
    for name in ("k", "v"):
        t = torch.einsum("btd,lde->lbte", enc, xa["w" + name])
        if cfg.qkv_bias:
            t = t + xa["b" + name][:, None, None]
        whole[name] = t.reshape(cfg.n_layers, B, T, cfg.n_kv_heads, cfg.hdim)
    blocks = shard_params(whole, sub.template, cache.mesh)
    for dst, src in zip(sub.blocks, blocks.blocks):
        for k in ("k", "v"):
            dst[k].copy_(src[k])
    del enc, whole, blocks


def family_cut(cfg):
    """The depth-cut config of phase 16's training checks: one super-block
    (``one_super_block``), whisper 2 encoder + 2 decoder layers."""
    import dataclasses
    if cfg.family == "audio":
        return dataclasses.replace(cfg, n_layers=2, n_encoder_layers=2)
    return one_super_block(cfg)


def tp_family_phase(cfg, dev, calls, *, prefill_len, meshes=FAMILY_MESHES,
                    train=FAMILY_TRAIN):
    """16a-c: ``cfg`` (whisper-large-v3, xlstm-1.3b or zamba2-2.7b, bf16,
    seed-0 weights, every layer) over ``meshes`` of logical ranks: a B x
    ``prefill_len`` forward (whisper with its frames) against ``mesh=None``
    at phase 7's bf16 rule (``_bf16_limit``), its collectives against
    :func:`family_collectives`, rank 0's parameter bytes, peak memory;
    teacher-forced decode of ``TP_CHECK_LEN`` steps on the sharded cache
    (whisper's cross cache filled from the encoder) against the mesh
    forward; at the first mesh ``serve_requests`` at phase 7's load (decode
    step p10 / p50 / p90).  The recurrent families also at one super-block
    (``one_super_block``), held as phase 7b holds it: within
    ``BF16_MODEL_MULTIPLE`` x the reference's own bf16 error + the fp32
    limit.  Then two fp32 train steps of the depth cut (:func:`family_cut`)
    at (2, 2) against ``mesh=None`` at ``TRAIN_PARITY_TOL`` (phase 15d's
    rule), plain, and for zamba2 also under ZeRO-1 + FSDP with 2
    microbatches (of the batch twice over)."""
    import numpy as np
    import torch
    from repro_torch.core.exchange import ShardMesh
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import lm
    from repro_torch.models.common import materialize, shard_params

    cell = {"audio": "16a", "ssm": "16b", "hybrid": "16c"}[cfg.family]
    params = materialize(torch.Generator(device=dev).manual_seed(0),
                         lm.model_template(cfg), device=dev)
    B_max = max(b for _, b in meshes)
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (B_max, prefill_len)), device=dev)
    extra = family_inputs(cfg, B_max, torch.Generator(device=dev).manual_seed(9), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, TP_SERVE["max_prompt"] + 1))
               for _ in range(TP_SERVE["requests"])]
    for shape, B in meshes:
        tag = f"{cell} {shape[0]}x{shape[1]}"
        b = {"tokens": tokens[:B], **{k: v[:B] for k, v in extra.items()}}
        with torch.no_grad():
            ref = lm.forward(cfg, params, b)
        limit, e_model = _bf16_limit(cfg, params, b, ref)
        mesh = ShardMesh([dev] * (shape[0] * shape[1]), *shape)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sp = shard_params(params, lm.model_template(cfg), mesh)
        mesh.collectives = 0
        with torch.no_grad():
            logits, secs = calls.run(tag, lambda: _timed(
                lambda: lm.forward(cfg, sp, b, mesh=mesh), dev, 1))
        per_forward = mesh.collectives
        err = scaled_err(logits.float(), ref.float())
        finite = bool(torch.isfinite(logits).all())
        peak = torch.cuda.max_memory_allocated() / 1e9
        del logits, ref
        short = {"tokens": b["tokens"][:, :TP_CHECK_LEN], **{k: v for k, v in b.items()
                                                             if k != "tokens"}}
        with torch.no_grad():
            full = calls.run(tag, lambda: lm.forward(cfg, sp, short, mesh=mesh))
        fill = (None if cfg.family != "audio" else
                lambda cache: fill_cross_sharded(cfg, params, sp, cache, short["frames"]))
        dec = calls.run(tag, lambda: _mesh_decode_err(cfg, sp, mesh, dev, full,
                                                      short["tokens"], fill))
        row = dict(phase="tp_family", model=cfg.name, family=cfg.family,
                   layers=cfg.n_layers, dtype="bfloat16", mesh=list(shape), batch=B,
                   tokens=prefill_len, **_rank_bytes(sp), collectives_per_forward=per_forward,
                   collectives_reckoned=family_collectives(cfg, mesh), vs_no_mesh_err=err,
                   limit=limit, bf16_vs_fp32_forward_err=e_model, decode_vs_forward_err=dec,
                   forward_s=secs[0], peak_mem_gb=peak,
                   note="logical ranks of one card: measures no scaling")
        if shape == meshes[0][0]:
            res = calls.run(tag, lambda: serve_requests(
                cfg, sp, prompts, batch=TP_SERVE["batch"], max_prompt=TP_SERVE["max_prompt"],
                max_new=TP_SERVE["max_new"], device=dev, mesh=mesh))
            toks = np.concatenate([o.ravel() for o in res["tokens"]])
            row.update(serve=TP_SERVE, serve_tokens_per_s=res["tokens_per_s"],
                       **_spread(res["step_s"]))
            require(toks.size == TP_SERVE["requests"] * TP_SERVE["max_new"]
                    and toks.min() >= 0 and toks.max() < cfg.vocab,
                    f"tp {cfg.name} {shape}: bad served tokens")
        emit(row)
        require(finite, f"tp {cfg.name} {shape}: non-finite mesh forward")
        require(per_forward == row["collectives_reckoned"],
                f"tp {cfg.name} {shape}: {per_forward} collectives a forward, reckoned "
                f"{row['collectives_reckoned']}")
        require(err <= limit and dec <= limit,
                f"tp {cfg.name} {shape}: vs mesh=None {err}, decode {dec}, limit {limit}")
        del sp, full
        torch.cuda.empty_cache()
    del params, extra
    torch.cuda.empty_cache()
    if cfg.family in ("ssm", "hybrid"):
        # one super-block at full width, as phase 7b: the reference's own
        # bf16 error bounds the bf16 drift between the mesh and none
        cut = one_super_block(cfg)
        p = materialize(torch.Generator(device=dev).manual_seed(0), lm.model_template(cut),
                        device=dev)
        b = {"tokens": tokens[:, :prefill_len]}
        tol = BF16_MODEL_MULTIPLE * BF16_REF_ERR[cfg.name] + LM_MODEL_TOL[cfg.family]
        with torch.no_grad():
            want = lm.forward(cut, p, b)
            errs = {f"{s[0]}x{s[1]}": scaled_err(calls.run(f"{cell} cut", lambda: lm.forward(
                cut, p, b, mesh=ShardMesh([dev] * (s[0] * s[1]), *s))).float(), want.float())
                for s, _ in meshes}
        emit(dict(phase="tp_family_super_block", model=cut.name, layers=cut.n_layers,
                  batch=B_max, tokens=prefill_len, vs_no_mesh_err=errs, tol=tol,
                  reference_bf16_err=BF16_REF_ERR[cfg.name]))
        require(all(e <= tol for e in errs.values()),
                f"tp {cfg.name} super-block vs mesh=None: {errs} over {tol}")
        del p, want
        torch.cuda.empty_cache()
    cut = family_cut(cfg)
    settings = [("plain", (), 1)]
    if cfg.family == "hybrid":
        settings.append(("zero1+fsdp", ("zero1_opt_state", "fsdp_params"), 2))
    for label, flags, mb in settings:
        rel, moment, ratio = _two_step_parity(cut, dev, (2, 2), flags, calls,
                                              f"{cell} train {label}", batch=train[0] * mb,
                                              seq=train[1], microbatches=mb)
        emit(dict(phase="tp_family_training_parity", model=cut.name, layers=cut.n_layers,
                  mesh=[2, 2], setting=label, microbatches=mb, batch=[train[0] * mb, train[1]],
                  rel_err=rel, moment_err=moment, param_err_over_limit=ratio,
                  tol=TRAIN_PARITY_TOL))
        require(all(v <= TRAIN_PARITY_TOL for v in rel.values()) and moment <= TRAIN_PARITY_TOL
                and ratio <= 1.0, f"tp {cut.name} training parity {label}: {rel} {moment} "
                f"{ratio}")
    torch.cuda.empty_cache()


def _host_moments(opt):
    """The 8-bit state's ``m``, ``m_scale`` and ``v``, each leaf whole on the
    host ({name: {path: tensor}}); a sharded leaf is unsharded on its own, so
    the card holds one whole leaf at a time."""
    from repro_torch.models.common import ShardedTree, tree_items, unshard_params
    out = {}
    for name in ("m", "m_scale", "v"):
        tree, leaves = getattr(opt, name), {}
        if not isinstance(tree, ShardedTree):
            leaves = {path: t.to("cpu", copy=True) for path, t in tree_items(tree)}
        else:
            per_rank = [dict(tree_items(b)) for b in tree.blocks]
            for (path, l), (_, spec) in zip(tree_items(tree.template), tree_items(tree.specs)):
                one = ShardedTree(tree.mesh, {"x": l}, {"x": spec},
                                  [{"x": b[path]} for b in per_rank])
                leaves[path] = unshard_params(one)["x"].to("cpu", copy=True)
        out[name] = leaves
    return out


def moments_agreement(got, want, dev, *, carried=None, b1=0.9, b2=0.95):
    """Two runs' 8-bit moments (:func:`_host_moments`) leaf by leaf, each
    error over its limit (1 = at the limit): the dequantized ``m`` within
    one int8 step of its row scale + ``TRAIN_PARITY_TOL`` of its leaf's
    largest |m| (|q s - q' s'| <= |q - q'| s + 127 |s - s'|), the scales
    within ``TRAIN_PARITY_TOL`` of their leaf's largest, ``v`` (bf16) within
    one bf16 ulp + twice that (``v`` is quadratic in the gradient).  After a
    second step (``carried``: both runs' moments after the first) a code
    that rounded apart at the first carries b1 x that step's scale into
    ``m``, and a bf16 ulp b2 x one into ``v``.  Returns (codes, codes that
    differ, most steps apart, {dq, scale, v: (worst ratio, its leaf)})."""
    import torch
    codes = flipped = steps_apart = 0
    worst = {k: (0.0, "") for k in ("dq", "scale", "v")}
    for path, q in want["m"].items():
        qn, qg = q.to(dev), got["m"][path].to(dev)
        sn, sg = want["m_scale"][path].to(dev), got["m_scale"][path].to(dev)
        diff = (qg.int() - qn.int()).abs()
        codes, flipped = codes + q.numel(), flipped + int((diff > 0).sum())
        steps_apart = max(steps_apart, int(diff.max()))
        dn = qn.float() * sn
        lim = torch.maximum(sg, sn) + TRAIN_PARITY_TOL * float(dn.abs().max())
        s_lim = TRAIN_PARITY_TOL * float(sn.max())
        vn, vg = want["v"][path].to(dev).float(), got["v"][path].to(dev).float()
        v_lim = BF16_ULP * vn.abs() + 2 * TRAIN_PARITY_TOL * float(vn.abs().max()) + 1e-30
        if carried is not None:
            s1 = torch.maximum(carried[0]["m_scale"][path].to(dev),
                               carried[1]["m_scale"][path].to(dev))
            lim = lim + b1 * s1
            s_lim = s_lim + b1 * s1 / 127
            v_lim = v_lim + b2 * BF16_ULP * vn.abs()
        ratios = {"dq": float(((qg.float() * sg - dn).abs() / lim).max()),
                  "scale": float(((sg - sn).abs() / s_lim).max()),
                  "v": float(((vg - vn).abs() / v_lim).max())}
        for k, r in ratios.items():
            if r > worst[k][0]:
                worst[k] = (r, "/".join(path))
        del qn, qg, sn, sg, diff, dn, lim, vn, vg, v_lim
    return codes, flipped, steps_apart, worst


def tp_8bit_phase(cfg, dev, calls, *, shape=Q8_SHAPE, seq=Q8_SEQ):
    """16d: two fp32 train steps of ``cfg`` (deepseek-v2 x2) with 8-bit
    moments (``opt_state_bits`` forced to 8) at ``shape``, against two
    mesh-less 8-bit steps routing the same token blocks (as 15c): losses and
    grad norms at ``TRAIN_PARITY_TOL``, and the moments after each step by
    :func:`moments_agreement`.  The moments wait on the host."""
    import torch
    from repro_torch.core.exchange import ShardMesh
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.launch.train import batch_tensors
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    from repro_torch.models.common import materialize, shard_params
    from repro_torch.optim.adamw import adamw_init

    pipe = TokenPipeline(cfg, seq_len=seq, global_batch=shape[0])
    data = [batch_tensors(pipe.global_batch_at(i), dev) for i in range(2)]
    bits, layer = steps.opt_state_bits, MOE.moe_layer

    def run(mesh):
        p = materialize(torch.Generator(device=dev).manual_seed(0), lm.model_template(cfg),
                        dtype_override="float32", device=dev)
        if mesh is not None:
            p = shard_params(p, lm.model_template(cfg), mesh)
        opt = adamw_init(p, 8)
        step = steps.make_train_step(cfg, mesh, peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS)
        ms, states = [], []
        for d in data:
            p, opt, m = step(p, opt, d)
            ms.append({k: float(v) for k, v in m.items()})
            states.append(_host_moments(opt))
        del p, opt
        torch.cuda.empty_cache()
        return states, ms

    steps.opt_state_bits = lambda c: 8
    try:
        def routed(cfg_, p, x, mesh=None, token_chunks=4):
            return layer(cfg_, p, x, mesh=mesh, token_chunks=token_chunks * shape[0])
        MOE.moe_layer = routed
        try:
            want, mw = run(None)
        finally:
            MOE.moe_layer = layer
        torch.cuda.reset_peak_memory_stats()
        mesh = ShardMesh([dev] * (shape[0] * shape[1]), *shape)
        got, mg = calls.run("16d", lambda: run(mesh))
        peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        steps.opt_state_bits = bits
    rel = {f"{k}_{i}": abs(a[k] - b[k]) / max(1e-30, abs(b[k]))
           for i, (a, b) in enumerate(zip(mg, mw)) for k in ("loss", "grad_norm")}
    row = dict(phase="tp_8bit_training", model=cfg.name, layers=cfg.n_layers,
               mesh=list(shape), batch=[shape[0], seq], state_bits=8, rel_err=rel,
               tol=TRAIN_PARITY_TOL, peak_mem_gb=peak,
               note="logical ranks of one card: measures no scaling")
    ok = all(v <= TRAIN_PARITY_TOL for v in rel.values())
    for i in range(2):
        codes, flipped, apart, worst = moments_agreement(
            got[i], want[i], dev, carried=None if i == 0 else (got[0], want[0]))
        row[f"step{i + 1}"] = dict(codes=codes, codes_differing=flipped, most_steps_apart=apart,
                                   **{f"{k}_err_over_limit": w[0] for k, w in worst.items()},
                                   worst_leaves={k: w[1] for k, w in worst.items()})
        ok = ok and all(w[0] <= 1.0 for w in worst.values())
    emit(row)
    require(ok, f"tp 8-bit {cfg.name}: {row}")
    del got, want
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 17: the dry run on the meta device against the card
# ---------------------------------------------------------------------------

#: the dry run's predicted peak (arguments + temp) within this share of the
#: measured ``max_memory_allocated`` above the step's base
DRYRUN_PEAK_TOL = 0.10
#: 17a's cells: (label, config, dry-run shape name, (seq, batch, kind))
CALIBRATION = (("qwen2-1.5b", "dense", "cal_train", (1024, 4, "train")),
               ("deepseek-v2-236b_x2", "moe", "cal_prefill", (512, 1, "prefill")))
#: 17b's production cells
PRODUCTION_CELLS = (("qwen3-32b", "train_4k", "single"),
                    ("deepseek-v3-671b", "decode_32k", "multipod"))


def _real_step_inputs(cfg, mesh, shape, dev, gen):
    """The dry run's arguments of ``shape`` as tensors on ``dev`` for a
    one-rank mesh: the same blocks (whole leaves), dtypes and specs, params
    from ``gen``, moments and cache zeros, tokens in the vocabulary."""
    import torch
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.steps import maybe_fsdp, opt_state_bits
    from repro_torch.models import lm
    from repro_torch.models.common import materialize, shard_params
    from repro_torch.optim.adamw import adamw_init

    S, B, kind = SHAPES[shape]
    tmpl = maybe_fsdp(lm.model_template(cfg))
    params = shard_params(materialize(gen, tmpl, device=dev), tmpl, mesh)
    opt = adamw_init(params, opt_state_bits(cfg)) if kind == "train" else None
    S_tok = S - lm.VLM_PATCHES if cfg.family == "vlm" else S
    tokens = torch.randint(0, cfg.vocab, (B, 1 if kind == "decode" else S_tok),
                           generator=gen, device=dev).to(torch.int32)
    cache = lm.init_cache(cfg, B, S, mesh=mesh) if kind == "decode" else None
    return params, opt, cache, {"tokens": tokens}


def dryrun_calibration_phase(cfgs, dev):
    """17a: each calibration cell's real step through one NCCL rank,
    counted and measured, against the dry run of the cell on
    ``ShardMesh.abstract(1, 1)``.  Returns the kernels' launches by cell."""
    import gc
    import math
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.exchange import ShardMesh
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.moe_dispatch import kernel as GK
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import make_prefill_step, make_train_step

    dev = torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" else dev
    store = ROOT / "build" / "pg_store_dryrun"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    launches = {}
    for label, fam, shape, dims in CALIBRATION:
        SHAPES[shape] = dims
    dist.init_process_group(backend, store=dist.FileStore(str(store), 1), rank=0,
                            world_size=1,
                            **({"device_id": dev} if dev.type == "cuda" else {}))
    try:
        for label, fam, shape, (S, B, kind) in CALIBRATION:
            cfg = cfgs[fam]
            t0 = time.perf_counter()
            pred = dryrun.run_step(cfg, ShardMesh.abstract(1, 1), shape)
            dry_s = time.perf_counter() - t0
            mesh = ShardMesh.from_process_group(device=dev)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            gen = torch.Generator(device=dev).manual_seed(0)
            params, opt, _, batch = _real_step_inputs(cfg, mesh, shape, dev, gen)
            args = torch.cuda.memory_allocated() - base
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            FK.reset_launches()
            GK.reset_launches()
            counter = dryrun.StepCounter()
            t0 = time.perf_counter()
            with counter:
                if kind == "train":
                    out = make_train_step(cfg, mesh)(params, opt, batch)
                else:
                    out = make_prefill_step(cfg, mesh)(params, batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            launches[label] = {**FK.LAUNCHES, **GK.LAUNCHES}
            result = float(out[2]["loss"] if kind == "train" else out.float().abs().max())
            mem = pred["memory"]
            rel = (mem["peak_bytes"] - peak) / peak
            emit(dict(phase="dryrun_calibration", cell=label, kind=kind, batch=B, seq=S,
                      predicted_peak_gb=mem["peak_bytes"] / 1e9, measured_peak_gb=peak / 1e9,
                      peak_rel_err=rel, predicted_args_gb=mem["argument_size_in_bytes"] / 1e9,
                      measured_args_gb=args / 1e9,
                      predicted_temp_gb=mem["temp_size_in_bytes"] / 1e9,
                      predicted_flops=pred["flops"], counted_flops=counter.flops,
                      kernel_flops={k: v["flops"] for k, v in counter.kernels.items()},
                      predicted_collectives=pred["collective_counts"],
                      census=mesh.census()[1], dry_run_s=dry_s, step_s=step_s,
                      loss_or_max_logit=result, launches=launches[label],
                      note="one NCCL rank: the real step on the card against the "
                           "dry run's rank of a (1, 1) mesh on the meta device"))
            require(counter.flops == pred["flops"],
                    f"{label}: the card's step counts {counter.flops} FLOPs, the dry run "
                    f"{pred['flops']}")
            require(abs(rel) <= DRYRUN_PEAK_TOL,
                    f"{label}: predicted peak {mem['peak_bytes'] / 1e9:.3f} GB is "
                    f"{rel:+.1%} of the measured {peak / 1e9:.3f} GB")
            require(mesh.census() == (pred["collective_bytes"], pred["collective_counts"]),
                    f"{label}: the group step's census differs from the dry run's")
            require(math.isfinite(result), f"{label}: non-finite result")
            del params, opt, batch, counter, out
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
        for _, _, shape, _ in CALIBRATION:
            SHAPES.pop(shape, None)
    return launches


def dryrun_production_phase():
    """17b: production cells of the dry run, timed on the host (meta
    device, no card used)."""
    from repro_torch.launch import dryrun
    for arch, shape, mesh_kind in PRODUCTION_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, mesh_kind, force=True, probe=False,
                              report_dir=ROOT / "build" / "dryrun_torch")
        require(rec["status"] == "ok", f"dry run of {arch}/{shape}/{mesh_kind}: "
                f"{rec.get('error')}")
        mem = rec["memory"]
        emit(dict(phase="dryrun_production", arch=arch, shape=shape, mesh=mesh_kind,
                  n_devices=rec["n_devices"], host_s=time.perf_counter() - t0,
                  rank_gb=(mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 1e9,
                  argument_gb=mem["argument_size_in_bytes"] / 1e9,
                  temp_gb=mem["temp_size_in_bytes"] / 1e9, fits=rec["fits"],
                  fits_budget_gb=rec["fits_budget_bytes"] / 1e9,
                  fits_budget_of=rec["fits_budget_of"], tflop_rank=rec["flops"] / 1e12,
                  collective_gb={k: v / 1e9 for k, v in rec["collective_bytes"].items()},
                  collective_counts=rec["collective_counts"]))


def examples_phase():
    """17c: the four example modules at their default sizes on the card.
    Returns the tile kernels' launches of the kernel-path demo."""
    from repro_torch.kernels.tile_spmm import kernel as K
    from repro_torch.launch import kernel_path_demo, quickstart, serve_async, serve_gnn
    t0 = time.perf_counter()
    q = quickstart.main([])
    emit(dict(phase="example_quickstart", err_tiled=q["err_tiled"],
              err_pipelined=q["err_pipelined"], limit=q["limit"], wall_s=q["wall_s"],
              simulator_modelled=q["sim"], seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    K.reset_launches()
    d = kernel_path_demo.main([])
    demo = dict(K.LAUNCHES)
    emit(dict(phase="example_kernel_path_demo", err_spmm=d["err_spmm"], err_gat=d["err_gat"],
              spmm_s=d["spmm_s"], softmax_s=d["softmax_s"], launches=demo,
              seconds=time.perf_counter() - t0))
    for name in ("tile_spmm", "segment_softmax"):
        require(demo[name] > 0, f"kernel {name} was not launched by the kernel-path demo")
    t0 = time.perf_counter()
    g = serve_gnn.main([])
    emit(dict(phase="example_serve_gnn", err=g["err"], latency_s=g["latency_s"],
              stats=g["stats"], seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    a = serve_async.main([])
    emit(dict(phase="example_serve_async", served=a["served"], n=a["n"], err=a["err"],
              latency_s=a["metrics"]["latency_s"], cache=a["cache"],
              sheds={k: list(v) for k, v in a["sheds"].items()},
              seconds=time.perf_counter() - t0))
    return demo


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.gnn import graphs as G
    from repro_torch.core.tiling import grid_tile
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.moe_dispatch import kernel as GK
    from repro_torch.kernels.relation_gemm import kernel as RK
    from repro_torch.kernels.tile_spmm import kernel as K
    from repro_torch.serve import ShapeRegistry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count()))

    # 2. build: one nvcc per source, all started at once, then load each
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        list(pool.map(_build.build, [m.SOURCE for m in (K, FK, GK, RK)]))
    ptxas = {}
    for m in (K, FK, GK, RK):
        m.library()
        log = _build.library_path(m.SOURCE).with_suffix(".log")
        ptxas[m.SOURCE.name] = [ln.strip() for ln in log.read_text().splitlines()
                                if "registers" in ln or "spill" in ln]
    emit(dict(phase="build", seconds=time.perf_counter() - t0, ptxas=ptxas))

    # main-path inputs (host): the serving batch and the whole graph
    t0 = time.perf_counter()
    graphs = [G.random_graph(2000, 16000, seed=i, model="powerlaw")
              for i in range(16)]
    _, serve_tiles, _, _ = ShapeRegistry().canonical(
        "shapes", G.batch_graphs(graphs).graph)
    dblp = G.paper_graph("coAuthorsDBLP")
    csr_tiles = grid_tile(dblp, 64, 64, sparse=True, layout="csr")
    emit(dict(phase="tiling", seconds=time.perf_counter() - t0,
              serving=dict(tiles=serve_tiles.n_tiles, s_max=serve_tiles.s_max,
                           e_max=serve_tiles.e_max,
                           parts=serve_tiles.n_dst_parts,
                           d_max=int(serve_tiles.part_size.max())),
              whole_graph=dict(graph=dblp.name, tiles=csr_tiles.n_tiles,
                               s_max=csr_tiles.s_max, e_max=csr_tiles.e_max,
                               parts=csr_tiles.n_dst_parts,
                               d_max=int(csr_tiles.part_size.max()))))

    # 3. kernel checks
    rows = kernel_checks(serve_tiles, csr_tiles, dblp.n_vertices, dev)

    # 4-5. the main path, with launch counts
    K.reset_launches()
    serving_phase(graphs, dev)
    whole_graph_phase(dblp, csr_tiles, dev)
    launches = dict(K.LAUNCHES)
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    # 5b. R-GCN as published at its cell's shapes
    rel_row, launches["relation_gemm"] = relational_phase(dblp, dev)
    rows.append(rel_row)

    # 6. LM kernel checks, at the shapes of phase 7's models: full width,
    # DeepSeek-V2 and Qwen2-VL cut to 2 layers (80 layers of the VLM would
    # not fit the card in fp32)
    lm_cfgs = {"dense": get_config("qwen2-1.5b"),
               "moe": dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=2),
               "vlm": dataclasses.replace(get_config("qwen2-vl-72b"), n_layers=2),
               "audio": get_config("whisper-large-v3"),
               "ssm": get_config("xlstm-1.3b"),
               "hybrid": get_config("zamba2-2.7b")}
    lm_rows = lm_kernel_checks(lm_cfgs, dev)
    lm_backward_checks(lm_cfgs, dev)

    # 7. LM serving of all six families in the templates' dtype (bf16), and
    # qwen2-1.5b once more in fp32, with launch counts; the flash kernel must
    # launch on each family that attends (ssm has no attention)
    FK.reset_launches()
    GK.reset_launches()
    lm_models = [("qwen2-1.5b", lm_cfgs["dense"], PREFILL_LEN, None),
                 ("deepseek-v2-236b_x2", lm_cfgs["moe"], PREFILL_LEN, None),
                 ("qwen2-vl-72b_x2", lm_cfgs["vlm"], PREFILL_LEN, None),
                 ("whisper-large-v3", lm_cfgs["audio"], WHISPER_DECODER_LEN, None),
                 ("xlstm-1.3b", lm_cfgs["ssm"], XLSTM_PREFILL_LEN, None),
                 ("zamba2-2.7b", lm_cfgs["hybrid"], PREFILL_LEN, None),
                 ("qwen2-1.5b_fp32", lm_cfgs["dense"], PREFILL_LEN, "float32")]
    flash_by_model = lm_serving_phase(lm_models, dev)
    lm_launches = {**FK.LAUNCHES, **GK.LAUNCHES}
    emit(dict(phase="lm_launches", **lm_launches, flash_by_model=flash_by_model))
    for name, n in lm_launches.items():
        require(n > 0, f"kernel {name} was not launched on the LM serving path")
    for label, cfg, _, _ in lm_models:
        require(flash_by_model[label] > 0 or cfg.family == "ssm",
                f"the flash kernel was not launched serving {label}")
    launches.update(lm_launches)
    # 7b. bf16 decode of xlstm and zamba2 at full width and one super-block,
    # against the reference's own bf16 error (off the count: the counts of
    # phase 7 are read)
    recurrent_bf16_check(lm_cfgs, dev)

    # 8. the tiled interpreter on the serving batch, with launch counts
    K.reset_launches()
    tiled_phase(graphs, dev)
    tiled_launches = dict(K.LAUNCHES)
    emit(dict(phase="tiled_launches", **tiled_launches))
    for name, n in tiled_launches.items():
        require(n > 0, f"kernel {name} was not launched by run_tiled")

    # 9. the async tier: 64 single-graph requests of the class, a model
    more = [G.random_graph(2000, 16000, seed=i, model="powerlaw")
            for i in range(len(graphs), 64)]
    K.reset_launches()
    async_serving_phase(graphs + more, dev)
    emit(dict(phase="async_serving_launches", **K.LAUNCHES))
    for name in ("tile_spmm", "segment_softmax"):
        require(K.LAUNCHES[name] > 0, f"kernel {name} was not launched by the async tier")

    # 10. the autotuner's wall-clock step and the tuned route
    K.reset_launches()
    autotune_phase(graphs, dev)
    emit(dict(phase="autotune_launches", **K.LAUNCHES))
    require(K.LAUNCHES["tile_spmm"] + K.LAUNCHES["tile_spmm_csr"] > 0,
            "no SpMM kernel was launched by the tuned route")

    # 11. sharded execution over 4 logical shards of the card; only the
    # sharded calls count, not the unsharded baselines beside them
    K.reset_launches()
    by_part = sharded_phase(graphs, dblp, csr_tiles, dev)
    sharded_launches = {name: sum(p.get(name, 0) for p in by_part.values())
                        for name in K.LAUNCHES}
    emit(dict(phase="sharded_launches", **sharded_launches, by_part=by_part))
    for name, n in sharded_launches.items():
        require(n > 0, f"kernel {name} was not launched on the sharded path")

    # 12. training: the kernels against the plain versions on a 2-layer fp32
    # cut of qwen2-1.5b (two steps) and on deepseek-v2 x2 (gradients), then 4 bf16 steps of qwen2-1.5b (28 layers) and
    # deepseek-v2 x2 at full width with launch counts, then the checkpoint
    # round trip on a 2-layer bf16 cut
    two_layers = dataclasses.replace(lm_cfgs["dense"], n_layers=2)
    training_parity(two_layers, dev, batch=TRAIN_SHAPES["dense"][0],
                    seq=TRAIN_SHAPES["dense"][1])
    gradient_parity(lm_cfgs["moe"], dev, batch=TRAIN_SHAPES["moe"][0],
                    seq=TRAIN_SHAPES["moe"][1])
    FK.reset_launches()
    GK.reset_launches()
    train_launches = {}
    for label, fam in (("qwen2-1.5b", "dense"), ("deepseek-v2-236b_x2", "moe")):
        before = {**FK.LAUNCHES, **GK.LAUNCHES}
        B, S = TRAIN_SHAPES[fam]
        train_model(label, lm_cfgs[fam], dev, batch=B, seq=S)
        train_launches[label] = {k: n - before[k] for k, n in {**FK.LAUNCHES,
                                                                **GK.LAUNCHES}.items()}
    emit(dict(phase="training_launches", **FK.LAUNCHES, **GK.LAUNCHES,
              by_model=train_launches))
    for label, n in train_launches.items():
        require(n["flash_attention"] > 0, f"the flash kernel was not launched training {label}")
    require(train_launches["deepseek-v2-236b_x2"]["grouped_ffn"] > 0,
            "the grouped FFN kernel was not launched training deepseek-v2-236b_x2")
    checkpoint_roundtrip(two_layers, dev, batch=2, seq=256)

    # 13. GNN training through the scan path: oracle parity, the example at
    # full width on its graph and on ak2010, 1-layer gin through the SpMM
    # kernels (launch counts), the refusals, and sharded gradients
    from repro_torch.launch.train_gnn import make_graph
    gnn_graph = make_graph()
    gnn_oracle_parity(gnn_graph, dev)
    for g in (gnn_graph, make_graph("ak2010")):
        gnn_train_run(g, dev)
    gnn_launches = gnn_kernel_and_sharded_checks(gnn_graph, dev)
    emit(dict(phase="gnn_training_launches", by_layout=gnn_launches))

    # 14. the mesh across processes as one NCCL rank (the card holds one;
    # NCCL refuses two ranks on a GPU), then expert-parallel deepseek-v2 x2
    # over logical shards of the card, with launch counts
    K.reset_launches()
    pg_launches = process_group_phase(dblp, csr_tiles, lm_cfgs["moe"], dev)
    emit(dict(phase="process_group_launches", **pg_launches))
    for name in ("tile_spmm_csr", "segment_softmax_csr"):
        require(pg_launches[name] > 0,
                f"kernel {name} was not launched on the process-group path")
    FK.reset_launches()
    GK.reset_launches()
    ep_launches = expert_parallel_phase(lm_cfgs["moe"], dev)
    emit(dict(phase="expert_parallel_launches", **ep_launches))
    for name, n in ep_launches.items():
        require(n > 0, f"kernel {name} was not launched on the expert-parallel path")

    # 15. the LM sharded by its specs over logical ranks of the card (and one
    # NCCL rank), with launch counts; one card measures no scaling
    # (only the meshed calls count, not the mesh=None baselines beside them;
    # then each kernel against its plain version on the inputs of the last
    # call of each shape the meshed calls made)
    calls = MeshCalls()
    for run_cell, cfg in ((tp_dense_phase, lm_cfgs["dense"]),
                          (tp_heads_phase, get_config("smollm-135m")),
                          (tp_moe_phase, lm_cfgs["moe"]), (tp_train_phase, lm_cfgs["dense"])):
        run_cell(cfg, dev, calls)
        calls.check()
    by_cell = calls.by_cell()
    tp_launches = {k: sum(c[k] for c in by_cell.values()) for k in ("flash_attention",
                                                                    "grouped_ffn")}
    emit(dict(phase="tp_launches", **tp_launches, by_cell=by_cell, by_call=calls.launches))
    for cell, n in by_cell.items():
        require(n["flash_attention"] > 0, f"the flash kernel was not launched in {cell}")
    require(by_cell["15c"]["grouped_ffn"] > 0, "the grouped FFN kernel was not launched in 15c")
    tp_group_phase(dataclasses.replace(lm_cfgs["dense"], n_layers=2), dev)

    # 16. the recurrent and encoder-decoder families laid out by their specs
    # over logical ranks of the card, full width and depth, then 8-bit
    # moments on a mesh; counted and checked as phase 15's calls
    calls = MeshCalls()
    t0 = time.perf_counter()
    for fam in ("audio", "ssm", "hybrid"):
        tp_family_phase(lm_cfgs[fam], dev, calls, prefill_len=FAMILY_PREFILL[fam])
        calls.check()
    tp_8bit_phase(lm_cfgs["moe"], dev, calls)
    calls.check()
    by_cell = calls.by_cell()
    emit(dict(phase="tp_family_launches", by_cell=by_cell, by_call=calls.launches,
              seconds=time.perf_counter() - t0))
    for cell in ("16a", "16c", "16d"):
        require(by_cell.get(cell, {}).get("flash_attention", 0) > 0,
                f"the flash kernel was not launched in {cell}")
    require(by_cell["16d"]["grouped_ffn"] > 0, "the grouped FFN kernel was not launched in 16d")

    # 17. the dry run against the card: the calibration steps through one
    # NCCL rank (launches counted around each step), two production cells
    # on the meta device, then the four examples (the tile kernels counted
    # around the kernel-path demo)
    t0 = time.perf_counter()
    cal = dryrun_calibration_phase(lm_cfgs, dev)
    for label, n in cal.items():
        require(n["flash_attention"] > 0, f"the flash kernel was not launched in 17a {label}")
    require(cal["deepseek-v2-236b_x2"]["grouped_ffn"] > 0,
            "the grouped FFN kernel was not launched in 17a's prefill")
    dryrun_production_phase()
    demo = examples_phase()
    emit(dict(phase="dryrun_and_examples_launches", calibration=cal, kernel_path_demo=demo,
              seconds=time.perf_counter() - t0))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: (launches[r["name"]] if k == "launches" else r[k])
                       for k in keys}
                      for r in rows + [r for r in lm_rows if r["primary"]]]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
