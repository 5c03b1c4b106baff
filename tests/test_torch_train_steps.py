"""The port's `make_train_step` against `repro.launch.steps.make_train_step`
(CPU, reduced configs, one config of each family, with and without gradient
accumulation) on the same numpy weights and the token pipeline's batches.

The reference runs jitted on a (1, 1) Auto-axis mesh built here, as in
tests/test_torch_lm.py.  Limit: 1e-4 x max(1, |ref|), the port's LM limit
(tests/test_torch_lm.py), over two steps of forward, backward and update.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AxisType

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.models.common import materialize as j_materialize
from repro.optim import adamw as jadamw
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm
from repro_torch.models.common import tree_items
from repro_torch.optim import adamw as tadamw

FAMILY_ARCHS = ["smollm-135m", "deepseek-v2-236b", "qwen2-vl-72b", "whisper-large-v3",
                "xlstm-1.3b", "zamba2-2.7b"]   # one config of each family
STEP_TOL = 1e-4


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _close(got, want, tol):
    got = np.asarray(got.detach().double().numpy(), np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _jleaves(tree):
    return [a for _, a in tree_items(tree)]


def _model(arch):
    """(port cfg, reference cfg, numpy float32 weights)."""
    jcfg = j_reduced(j_get_config(arch))
    np_tree = jax.tree.map(np.array, j_materialize(
        jax.random.PRNGKey(0), jlm.model_template(jcfg), dtype_override="float32"))
    return reduced(get_config(arch)), jcfg, np_tree


def _seq(cfg):
    return 16 + (lm.VLM_PATCHES if cfg.family == "vlm" else 0)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_make_train_step_matches_reference(arch, microbatches, mesh):
    """Two steps from the same fp32 weights on the pipeline's batches, the
    reference's jitted step against the port's: loss, grad norm, learning
    rate and every parameter."""
    cfg, jcfg, np_tree = _model(arch)
    jp = jax.tree.map(jnp.asarray, np_tree)
    tp = lm_params_from_reference(np_tree, cfg, device="cpu")
    js, ts = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    jstep = jax.jit(jsteps.make_train_step(jcfg, mesh, peak_lr=1e-2, total_steps=4,
                                           microbatches=microbatches))
    tstep = tsteps.make_train_step(cfg, peak_lr=1e-2, total_steps=4,
                                   microbatches=microbatches)
    pipe = JPipeline(jcfg, seq_len=_seq(cfg), global_batch=2)
    for step in range(2):
        b = pipe.global_batch_at(step)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, ttrain.batch_tensors(b, torch.device("cpu")))
        for k in ("loss", "grad_norm", "lr"):
            _close(tm[k], jm[k], STEP_TOL)
        for a, w in zip(_jleaves(tp), _jleaves(jp)):
            _close(a, w, STEP_TOL)
    assert not any(t.requires_grad for t in _jleaves(tp))
