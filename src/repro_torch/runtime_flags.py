"""Process-global tracing flags.

``PROBE`` drives the dry-run's *cost probes*: XLA's ``cost_analysis()`` does
not multiply FLOPs/bytes by ``while``-loop trip counts, so the production
step (scan-over-layers) undercounts.  The dry-run therefore lowers extra
"probe" variants with python-unrolled layer stacks (1 and 2 layers) and
unrolled inner scans, and extrapolates:  total = f(1) + (L-1)·(f(2) - f(1))
per stack.  Memory analysis and the collective *schedule* always come from
the real (scanned) compile.

  PROBE["stack_counts"]: None, or {stack_name: n_layers_to_trace}
  PROBE["unroll"]:       unroll inner scans (flash kv blocks, ssm chunks,
                         MoE token chunks) so their FLOPs are visible.

In the port (``repro_torch``) the dry run runs the eager step on the meta
device (``launch/dryrun.py``) and counts every dispatched op, so nothing is
hidden in a loop.  ``PROBE["stack_counts"]`` is honoured all the same: the
layer loops that a mesh runs (``models/lm.py``) take the first n layers of
each named stack, and the MoE routes its tokens in one chunk, so the dry
run's 1- and 2-layer probes cost seconds where the full step costs minutes.
``PROBE["unroll"]`` is a no-op: every inner loop is already a Python loop.
"""
from typing import Dict, Optional

PROBE: Dict = {"stack_counts": None, "unroll": False}

#: beyond-baseline optimization toggles (§Perf hillclimbs) — default OFF so
#: the recorded baselines stay reproducible; the hillclimb driver flips them.
OPT: Dict = {
    "attn_batch_shard": False,   # batch-shard attention when heads % model != 0
    "moe_rs_combine": False,     # reduce-scatter + thin return-a2a MoE combine
    "moe_fp8_dispatch": False,   # fp8 payload on the forward dispatch all_to_all
    "zero1_opt_state": False,    # shard optimizer moments over the data axes
    "fsdp_params": False,        # shard params over data too (per-layer all-gather)
    "remat_save_dots": False,    # checkpoint policy: save matmul/collective outs
}


def probe_stacks() -> Optional[Dict[str, int]]:
    return PROBE["stack_counts"]


def probe_unroll() -> bool:
    return bool(PROBE["unroll"])
