"""How far the reference's own bf16 forward drifts from its fp32 forward for
the recurrent LM families, beside the port's on the same weights (CPU).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/bf16_drift.py [SHAPE ...]

For xlstm-1.3b and zamba2-2.7b, on bf16 weights from the port's
``materialize`` with a CPU generator seeded 0-2 (the same numbers on any
machine; the reference gets them bit for bit) and the fp32 copy of those
same weights, over one sequence of 8 tokens drawn as ``chip_smoke.py``
phase 7 draws its decode check's (``default_rng(3)``):

* e_ref  = max|ref_bf16 - ref_fp32| / max(1, max|ref_fp32|), the reference's
  own bf16 error;
* e_port = the same for the port's forward on the same weights;
* port_vs_ref = max|port_bf16 - ref_bf16| on the same scale;
* weights = ``chip_smoke.weights_fingerprint`` of the bf16 weights.

Two shapes each:

* ``full_width_cut`` — the published widths, depth cut to one super-block
  of two blocks (``chip_smoke.one_super_block``: xLSTM one mLSTM and one
  sLSTM; Zamba2 two Mamba2 blocks and the shared attention block).
  ``chip_smoke.py`` phase 7b runs the port on the card on seed 0's weights
  (it checks the fingerprint) and holds it to seed 0's e_ref
  (``BF16_REF_ERR``);
* ``reduced_full_depth`` — the reduced widths (``configs.reduced``) at the
  published depth and super-block (48 layers, ``slstm_every=8``; 54 layers,
  ``shared_attn_every=6``): how the drift grows with depth in each package.

The full widths at the full depth (3.6 B and 2.4 B parameters) run only on
the card, where the reference cannot run.  Prints one JSON line per
(shape, arch, seed).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AxisType

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced as j_reduced  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import materialize, tree_map  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ARCHS = ("xlstm-1.3b", "zamba2-2.7b")
SEEDS = (0, 1, 2)
CHECK_LEN = 8          # chip_smoke.py lm_serving_phase's check_len


def full_depth(small, full):
    """``small`` (a reduced config) at ``full``'s depth and super-block."""
    if full.xlstm is not None:
        return dataclasses.replace(small, n_layers=full.n_layers, xlstm=dataclasses.replace(
            small.xlstm, slstm_every=full.xlstm.slstm_every))
    return dataclasses.replace(small, n_layers=full.n_layers,
                               shared_attn_every=full.shared_attn_every)


def shape_cfg(shape: str, make, small, arch: str):
    """The config of ``arch`` at ``shape`` from ``make`` (a package's
    ``get_config``), ``small`` being its ``reduced``."""
    if shape == "full_width_cut":
        return chip_smoke.one_super_block(make(arch))
    return full_depth(small(make(arch)), make(arch))


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def measure(shape: str, arch: str, seed: int, mesh) -> dict:
    jcfg = shape_cfg(shape, j_get_config, j_reduced, arch)
    cfg = shape_cfg(shape, get_config, reduced, arch)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (1, CHECK_LEN))
    tb = materialize(torch.Generator().manual_seed(seed), lm.model_template(cfg),
                     device="cpu")
    fingerprint = chip_smoke.weights_fingerprint(tb)
    tt = torch.as_tensor(tokens)
    with torch.no_grad():
        port_b = _f64(lm.forward(cfg, tb, {"tokens": tt}))
        port_f = _f64(lm.forward(cfg, tree_map(lambda t: t.float(), tb), {"tokens": tt}))
    fwd = jax.jit(lambda p, t: jlm.forward(jcfg, p, {"tokens": t}, mesh=mesh))
    jf = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()), tb)
    del tb
    ref_f = _f64(fwd(jf, jnp.asarray(tokens, jnp.int32)))
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jf)   # exact: bf16 values
    del jf
    ref_b = _f64(fwd(jb, jnp.asarray(tokens, jnp.int32)))
    scale = max(1.0, float(np.abs(ref_f).max()))
    return dict(shape=shape, arch=arch, seed=seed, n_layers=cfg.n_layers,
                d_model=cfg.d_model, weights=fingerprint,
                max_abs_ref_fp32=float(np.abs(ref_f).max()),
                e_ref=float(np.abs(ref_b - ref_f).max()) / scale,
                e_port=float(np.abs(port_b - port_f).max()) / scale,
                port_vs_ref=float(np.abs(port_b - ref_b).max()) / scale,
                fp32_port_vs_ref=float(np.abs(port_f - ref_f).max()) / scale)


def main(argv=None) -> int:
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    for shape in argv or ("full_width_cut", "reduced_full_depth"):
        for arch in ARCHS:
            for seed in SEEDS:
                print(json.dumps(measure(shape, arch, seed, mesh)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
