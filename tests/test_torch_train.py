"""The port's training substrate against `repro` on the same numpy inputs
(CPU, reduced configs): AdamW (32- and 8-bit moments), the WSD schedule,
`global_norm`, `cross_entropy` and `loss_fn`, the token pipeline,
checkpoint/restart and gradient compression (`make_train_step` is held in
tests/test_torch_train_steps.py, a file of its own so that the test
workers run the two in parallel).

The reference runs on a (1, 1) Auto-axis mesh built here, as in
tests/test_torch_lm.py (`make_host_mesh` gives Explicit axes, which
`with_sharding_constraint` refuses under the installed jax).  Limits:
AdamW 1e-6 x max(1, |ref|) (the same float32 arithmetic in the same order;
what is left is XLA's fusion and the order of the norm's sum).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AxisType

from repro.configs import all_configs as j_all_configs
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.distributed import compression as jcomp
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models.common import materialize as j_materialize
from repro.optim import adamw as jadamw
from repro.optim.schedule import wsd_schedule as j_wsd
from repro_torch.checkpointing import (CheckpointManager, latest_step, restore_checkpoint,
                                       save_checkpoint)
from repro_torch.configs import get_config, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.distributed import compression as tcomp
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models import lm
from repro_torch.models.common import tree_items
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import wsd_schedule as t_wsd

FAMILY_ARCHS = ["smollm-135m", "deepseek-v2-236b", "qwen2-vl-72b", "whisper-large-v3",
                "xlstm-1.3b", "zamba2-2.7b"]   # one config of each family


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _close(got, want, tol):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max()) if want.size else 1.0), err


def _jleaves(tree):
    return [a for _, a in tree_items(tree)]


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------

def _tree(rng, scale):
    return {"w": (rng.standard_normal((9, 13)) * scale).astype(np.float32),
            "blk": {"b": (rng.standard_normal(7) * scale).astype(np.float32),
                    "e": (rng.standard_normal((1, 3, 5, 6)) * scale).astype(np.float32)}}


@pytest.mark.parametrize("bits", [32, 8])
def test_adamw_update_matches_reference(bits, rng, monkeypatch):
    """Five steps, alternating clipped (grad norm ~20) and unclipped (~0.05)
    gradients, one parameter in bf16; slices of 40 elements, so the larger
    leaves are updated in several slices of whole rows."""
    monkeypatch.setattr(tadamw, "SLICE_ELEMS", 40)
    p = _tree(rng, 1.0)
    jp = jax.tree.map(jnp.asarray, p)
    jp["blk"]["b"] = jp["blk"]["b"].astype(jnp.bfloat16)
    tp = jax.tree.map(torch.as_tensor, p)
    tp["blk"]["b"] = tp["blk"]["b"].bfloat16()
    js, ts = jadamw.adamw_init(jp, bits), tadamw.adamw_init(tp, bits)
    norms = []
    for step in range(5):
        g = _tree(rng, 3.0 if step % 2 == 0 else 0.01)
        lr = 1e-2 * (step + 1)
        jp, js, jn = jadamw.adamw_update(jp, js, jax.tree.map(jnp.asarray, g), lr,
                                         state_bits=bits)
        tp, ts, tn = tadamw.adamw_update(tp, ts, jax.tree.map(torch.as_tensor, g), lr,
                                         state_bits=bits)
        assert int(ts.step) == int(js.step) == step + 1
        _close(tn, jn, 1e-6)
        norms.append(float(tn))
        trees = [(tp, jp), (ts.m, js.m), (ts.v, js.v)]
        if bits == 8:
            trees.append((ts.m_scale, js.m_scale))
        for tt, jt in trees:
            for a, b in zip(_jleaves(tt), _jleaves(jt)):
                assert str(a.dtype).replace("torch.", "") == str(b.dtype)
                _close(a, b, 1e-6)
    assert min(norms) < 1.0 < max(norms)        # both sides of the clip


def test_wsd_schedule_matches_reference():
    for kw in ({}, dict(peak_lr=1e-3, warmup=10, total=100, decay_frac=0.5, min_ratio=0.2)):
        for step in (0, 1, 5, 10, 100, 199, 200, 201, 5000, 7999, 8000, 8001, 9000,
                     9999, 10_000, 12_000, 40, 50, 75, 99):
            got, want = t_wsd(step, **kw), j_wsd(step, **kw)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-12), (kw, step)


def test_global_norm_matches_reference(rng):
    tree = _tree(rng, 2.0)
    _close(tadamw.global_norm(jax.tree.map(torch.as_tensor, tree)),
           jadamw.global_norm(jax.tree.map(jnp.asarray, tree)), 1e-6)


@pytest.mark.parametrize("name", sorted(j_all_configs()))
def test_opt_state_bits_matches_reference(name):
    assert tsteps.opt_state_bits(get_config(name)) == \
        jsteps.opt_state_bits(j_all_configs()[name])


# ---------------------------------------------------------------------------
# the objective
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_reference(rng):
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    for z in (1e-4, 0.0):
        _close(tcommon.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                                     z_loss=z),
               jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z_loss=z),
               1e-6)
    bf = torch.as_tensor(logits).bfloat16()
    _close(tcommon.cross_entropy(bf, torch.as_tensor(labels)),
           jcommon.cross_entropy(jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16),
                                 jnp.asarray(labels)), 1e-6)


_WEIGHTS = {}


def _model(arch):
    """(port cfg, reference cfg, numpy float32 weights), cached."""
    if arch not in _WEIGHTS:
        jcfg = j_reduced(j_get_config(arch))
        np_tree = jax.tree.map(np.array, j_materialize(
            jax.random.PRNGKey(0), jlm.model_template(jcfg), dtype_override="float32"))
        _WEIGHTS[arch] = (reduced(get_config(arch)), jcfg, np_tree)
    return _WEIGHTS[arch]


def _seq(cfg):
    return 16 + (lm.VLM_PATCHES if cfg.family == "vlm" else 0)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_fn_matches_reference(arch, mesh):
    cfg, jcfg, np_tree = _model(arch)
    b = JPipeline(jcfg, seq_len=_seq(cfg), global_batch=2).global_batch_at(3)
    want = jax.jit(lambda p, b: jlm.loss_fn(jcfg, p, b, mesh=mesh))(
        jax.tree.map(jnp.asarray, np_tree), {k: jnp.asarray(v) for k, v in b.items()})
    got = lm.loss_fn(cfg, lm_params_from_reference(np_tree, cfg, device="cpu"),
                     ttrain.batch_tensors(b, torch.device("cpu")))
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# data, checkpoints, compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(j_all_configs()))
def test_token_pipeline_matches_reference(arch):
    cfg, jcfg = reduced(get_config(arch)), j_reduced(j_get_config(arch))
    for seed, step in ((0, 0), (3, 17)):
        got = TokenPipeline(cfg, seq_len=_seq(cfg), global_batch=4, seed=seed)
        want = JPipeline(jcfg, seq_len=_seq(cfg), global_batch=4, seed=seed)
        for a, b in ((got.global_batch_at(step), want.global_batch_at(step)),
                     (got.shard_for(step, 1, 2), want.shard_for(step, 1, 2))):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def _state_tree(rng):
    special = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"),
                            1e-40, 3.0e38, -1.5])
    params = {"emb": torch.as_tensor(rng.standard_normal((5, 4)).astype(np.float32)).bfloat16(),
              "odd": special.bfloat16(),
              "blk": {"w": torch.as_tensor(rng.standard_normal((2, 3)).astype(np.float32))}}
    opt = tadamw.adamw_init(params, 8)
    opt.m["emb"].copy_(torch.arange(-10, 10, dtype=torch.int8).reshape(5, 4))
    opt.v["blk"]["w"].copy_(torch.tensor([[1e-30, 2.0, 3.0], [4.0, 5.0, 6.0]]))
    return {"params": params, "opt": opt._replace(step=torch.tensor(7, dtype=torch.int32))}


def _bits_equal(a, b):
    from repro_torch.checkpointing.ckpt import _leaves
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y), k


def test_checkpoint_round_trip_keeps_dtypes_and_bf16_bit_patterns(tmp_path, rng):
    tree = _state_tree(rng)
    path = save_checkpoint(str(tmp_path), 7, tree)
    manifest = json.loads((path / "manifest.json").read_text())
    dtypes = {l["key"]: l["dtype"] for l in manifest["leaves"]}
    assert dtypes["params/odd"] == "bfloat16" and dtypes["opt/m/emb"] == "int8"
    assert dtypes["opt/step"] == "int32" and "opt/v_scale" not in str(dtypes)
    assert latest_step(str(tmp_path)) == 7
    back = restore_checkpoint(str(tmp_path), 7, tree)
    assert isinstance(back["opt"], tadamw.AdamWState) and back["opt"].v_scale is None
    _bits_equal(back, tree)


def test_checkpoint_written_by_the_reference_restores_bf16_bit_for_bit(tmp_path, rng):
    """The reference's np.savez stores a bf16 leaf as the void dtype |V2
    (ROADMAP C.6); the port restores it, and the f32 leaf beside it, bit for
    bit."""
    from repro.checkpointing import save_checkpoint as j_save
    a = rng.standard_normal((2, 3)).astype(np.float32)
    a[0, :2] = (np.inf, np.nan)
    b = rng.standard_normal(3).astype(np.float32)
    a16 = jnp.asarray(a, jnp.bfloat16)
    j_save(str(tmp_path), 3, {"a": a16, "b": jnp.asarray(b)})
    with np.load(tmp_path / "step_00000003" / "shard_00000.npz") as z:
        assert z["a"].dtype.kind == "V"             # what the repair is for
    like = {"a": torch.zeros((2, 3), dtype=torch.bfloat16), "b": torch.zeros(3)}
    back = restore_checkpoint(str(tmp_path), 3, like)
    # jax's bit patterns (its NaN is not torch's), viewed as bf16
    bits = torch.from_numpy(np.asarray(a16).view(np.int16).copy())
    _bits_equal(back, {"a": bits.view(torch.bfloat16), "b": torch.as_tensor(b)})


def test_checkpoint_commit_is_atomic_and_keeps_the_newest(tmp_path, rng):
    tree = _state_tree(rng)
    (tmp_path / "step_00000009.tmp").mkdir()            # a save cut mid-write
    assert latest_step(str(tmp_path)) is None
    for step in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), step, tree, keep=2)
    assert latest_step(str(tmp_path)) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000003", "step_00000004", "step_00000009.tmp"]
    mgr = CheckpointManager(str(tmp_path / "m"), keep=3, every=2)
    assert mgr.restore_latest(tree) == (None, None)
    w = tree["params"]["blk"]["w"]
    before = w.clone()
    for step in range(5):
        mgr.maybe_save(step, tree)
        w.add_(1.0)                  # training goes on updating in place
    mgr.maybe_save(5, tree, force=True)
    mgr.wait()
    assert latest_step(mgr.root) == 5
    assert sorted(p.name for p in (tmp_path / "m").iterdir()) == \
        ["step_00000002", "step_00000004", "step_00000005"]
    step, back = mgr.restore_latest(tree)
    assert step == 5
    assert torch.equal(back["params"]["blk"]["w"], w)
    assert torch.equal(restore_checkpoint(mgr.root, 2, tree)["params"]["blk"]["w"],
                       before + 2.0)


def _train(args, capsys):
    params = ttrain.main(args + ["--device", "cpu"])
    return params, capsys.readouterr().out


def test_train_restart_resumes_to_the_uninterrupted_params(tmp_path, capsys):
    """Killed after 3 steps and restarted to 6, the trainer ends on the
    params of an uninterrupted 6-step run, bit for bit."""
    args = ["--arch", "smollm-135m", "--reduced", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2"]
    _train(args + ["--steps", "3", "--ckpt-dir", str(tmp_path / "a")], capsys)
    assert latest_step(str(tmp_path / "a")) == 2
    resumed, out = _train(args + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")], capsys)
    assert "resumed from step 2" in out and "step     3" in out and "step     2" not in out
    assert latest_step(str(tmp_path / "a")) == 5
    straight, _ = _train(args + ["--steps", "6", "--ckpt-dir", str(tmp_path / "b")], capsys)
    _bits_equal(resumed, straight)


def test_quantize_grads_matches_reference_with_error_feedback(rng):
    tree = {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"c": (rng.standard_normal(11) * 1e-3).astype(np.float32)}}
    j_res = t_res = None
    for _ in range(3):
        owed = {p: torch.as_tensor(g) + (0 if t_res is None else dict(tree_items(t_res))[p])
                for p, g in tree_items(tree)}
        jq, js, j_res = jcomp.quantize_grads(jax.tree.map(jnp.asarray, tree), j_res)
        tq, ts, t_res = tcomp.quantize_grads(jax.tree.map(torch.as_tensor, tree), t_res)
        for a, b in zip(_jleaves(tq), _jleaves(jq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(_jleaves(ts) + _jleaves(t_res), _jleaves(js) + _jleaves(j_res)):
            _close(a, b, 1e-7)
        deq = tcomp.dequantize_grads(tq, ts)
        _close(deq["a"], jcomp.dequantize_grads(jq, js)["a"], 1e-7)
        # error feedback: what is sent plus what is carried is what was owed
        # (this step's gradient and the last step's residual)
        for (p, d), (_, r) in zip(tree_items(deq), tree_items(t_res)):
            assert float((d + r - owed[p]).abs().max()) <= 1e-6
