"""The LM laid out by its specs on 2 x 2 gloo ranks (one `torch.distributed`
rank a mesh rank), against the one-process `ShardMesh` of the same shape.

Each of 4 spawned ranks (a `FileStore` in the test's tmp dir, a 60 s group
timeout, a 300 s join deadline) reads only its data shard's rows, as
`TokenPipeline.shard_for` gives a host, and runs:
- `lm.forward` of reduced qwen2 (tensor-parallel attention and FFN,
  vocabulary-parallel embedding and logits) and deepseek-v2 (MLA, the
  expert-parallel MoE, shared experts);
- `lm.forward` and three `decode_step`s of reduced whisper (frames, a
  seeded cross cache), xlstm and zamba2 (the recurrent blocks' gathers and
  split norms, the sharded recurrent caches);
- two `make_train_step` steps of reduced deepseek-v2 with 8-bit moments
  (the row scales' `pmax` over the group);
- two `make_train_step` steps of reduced smollm, plain and under
  `zero1_opt_state` + `fsdp_params` with 2 microbatches, autograd passing
  through the group's collectives;
- a per-host checkpoint of the plain run's parameters and moments.
Each axis has 2 addends, so the order of a sum does not matter and every
rank equals the one-process mesh bit for bit; the checkpoint restores onto
(1, 1) and (4, 1) meshes equal to the one-process run's whole tree.

Nothing of `repro` is imported: the spawned ranks import this module.
"""
import datetime
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import runtime_flags
from repro_torch.checkpointing import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.core.exchange import ShardMesh
from repro_torch.launch import steps
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.models.common import materialize, shard_params, tree_items, unshard_params
from repro_torch.optim.adamw import adamw_init

SHAPE = (2, 2)
WORLD = SHAPE[0] * SHAPE[1]
DEADLINE_S = 300
FORWARD_ARCHS = ("qwen2-1.5b", "deepseek-v2-236b")
SETTINGS = {"plain": ((), 1), "zero1_fsdp_mb2": (("zero1_opt_state", "fsdp_params"), 2)}
FAMILY_ARCHS = ("whisper-large-v3", "xlstm-1.3b", "zamba2-2.7b")
DECODE_STEPS, CACHE_LEN = 3, 8


def _weights(arch):
    return materialize(torch.Generator().manual_seed(0), lm.model_template(reduced(
        get_config(arch))), "float32", "cpu")


def _tokens(arch, seed):
    cfg = reduced(get_config(arch))
    return torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab, (8, 16)))


def _family_batch(arch, rows):
    """``rows`` of the family's 8-row batch (tokens; whisper's frames)."""
    cfg = reduced(get_config(arch))
    b = {"tokens": rows(_tokens(arch, 1))}
    if cfg.family == "audio":
        b["frames"] = rows(torch.as_tensor(np.random.default_rng(2).standard_normal(
            (8, cfg.enc_len, cfg.d_model)), dtype=torch.float32))
    return b


def _family_decode(arch, mesh, rows):
    """Three decode steps of ``rows`` on a cache sharded over ``mesh``
    (whisper's cross cache seeded, each rank's block of it)."""
    cfg = reduced(get_config(arch))
    cache = lm.init_cache(cfg, 8, CACHE_LEN, dtype="float32", mesh=mesh)
    if cfg.family == "audio":
        sub = cache.sub("cross")
        rng = np.random.default_rng(7)
        whole = {k: torch.as_tensor(rng.standard_normal(l.shape), dtype=torch.float32)
                 for k, l in sub.template.items()}
        for dst, src in zip(sub.blocks, shard_params(whole, sub.template, mesh).blocks):
            for k in dst:
                dst[k].copy_(src[k])
    tokens, p, out = rows(_tokens(arch, 3)), _weights(arch), []
    with torch.no_grad():
        for pos in range(DECODE_STEPS):
            logits, cache = lm.decode_step(cfg, p, cache, tokens[:, pos:pos + 1], pos,
                                           mesh=mesh)
            out.append(logits)
    return out


def _train_8bit(mesh, rows):
    """Two steps of reduced deepseek-v2 with 8-bit moments on ``mesh``."""
    bits = steps.opt_state_bits
    steps.opt_state_bits = lambda cfg: 8
    try:
        cfg = reduced(get_config("deepseek-v2-236b"))
        p = _weights("deepseek-v2-236b")
        opt = adamw_init(p, 8)
        step = make_train_step(cfg, mesh, peak_lr=1e-2, total_steps=4)
        for i in range(2):
            p, opt, m = step(p, opt, {"tokens": rows(_tokens("deepseek-v2-236b", 20 + i))})
    finally:
        steps.opt_state_bits = bits
    return p, opt, (m["loss"], m["grad_norm"])


def _train(mesh, setting, rows):
    """Two steps of reduced smollm under ``setting`` on ``mesh``; ``rows``
    picks the batch rows the process reads."""
    flags, mb = SETTINGS[setting]
    cfg = reduced(get_config("smollm-135m"))
    for k in flags:
        runtime_flags.OPT[k] = True
    try:
        p = _weights("smollm-135m")
        opt = adamw_init(p)
        step = make_train_step(cfg, mesh, peak_lr=1e-2, total_steps=4, microbatches=mb)
        metrics = []
        for i in range(2):
            p, opt, m = step(p, opt, {"tokens": rows(_tokens("smollm-135m", 10 + i))})
            metrics.append((m["loss"], m["grad_norm"]))
    finally:
        for k in flags:
            runtime_flags.OPT[k] = False
    return p, opt, metrics


def _rank_main(rank, tmp):
    """One gloo rank: its shard's forwards, both training settings, a
    per-host checkpoint; results to ``rank{rank}.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    mesh = ShardMesh.from_process_group(SHAPE[1], device="cpu")
    k = mesh.local_shards[0]

    def rows(x):
        per = x.shape[0] // SHAPE[0]
        return x[k * per:(k + 1) * per]

    out = {}
    with torch.no_grad():
        for arch in FORWARD_ARCHS:
            cfg = reduced(get_config(arch))
            o = lm.forward(cfg, _weights(arch), {"tokens": rows(_tokens(arch, 1))}, mesh=mesh)
            out[f"forward/{arch}"] = o[0] if cfg.family == "moe" else o
        for arch in FAMILY_ARCHS:
            cfg = reduced(get_config(arch))
            out[f"forward/{arch}"] = lm.forward(cfg, _weights(arch), _family_batch(arch, rows),
                                                mesh=mesh)
    for arch in FAMILY_ARCHS:
        out[f"decode/{arch}"] = _family_decode(arch, mesh, rows)
    p, opt, metrics = _train_8bit(mesh, rows)
    out["train/q8"] = (opt.m.blocks[0], opt.m_scale.blocks[0], opt.v.blocks[0], metrics)
    for setting in SETTINGS:
        p, opt, metrics = _train(mesh, setting, rows)
        out[f"train/{setting}"] = (p.blocks[0], opt.m.blocks[0], opt.v.blocks[0], metrics)
        if setting == "plain":
            save_checkpoint(f"{tmp}/ckpt", 1, {"params": p, "opt": opt}, host_id=rank,
                            n_hosts=WORLD)
    out["jax_or_repro_modules"] = sorted(m for m in sys.modules
                                         if m.startswith("jax") or m.split(".")[0] == "repro")
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_dist")
    ctx = mp.start_processes(_rank_main, args=(str(tmp),), nprocs=WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the {WORLD}-rank gloo world did not finish in {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return tmp, [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _one_process():
    return ShardMesh(["cpu"] * WORLD, *SHAPE)


@pytest.fixture
def one_thread():
    """The ranks' thread count for the one-process run: the CPU's
    embedding backward accumulates repeated tokens across threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_on_gloo_ranks_equals_one_process(ranks, arch, one_thread):
    _, res = ranks
    cfg = reduced(get_config(arch))
    with torch.no_grad():
        want = lm.forward(cfg, _weights(arch), {"tokens": _tokens(arch, 1)},
                          mesh=_one_process())
    want = want[0] if cfg.family == "moe" else want
    per = want.shape[0] // SHAPE[0]
    for r, out in enumerate(res):
        k = r // SHAPE[1]
        assert torch.equal(out[f"forward/{arch}"], want[k * per:(k + 1) * per]), r


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_forward_and_decode_on_gloo_ranks_equal_one_process(ranks, arch, one_thread):
    """The audio, ssm and hybrid families' forward and three decode steps
    on each rank equal the one-process mesh's rows of its shard, bit for
    bit."""
    _, res = ranks
    cfg = reduced(get_config(arch))
    mesh = _one_process()
    with torch.no_grad():
        want = lm.forward(cfg, _weights(arch), _family_batch(arch, lambda x: x), mesh=mesh)
    steps_want = _family_decode(arch, mesh, lambda x: x)
    per = want.shape[0] // SHAPE[0]
    for r, out in enumerate(res):
        k = r // SHAPE[1]
        assert torch.equal(out[f"forward/{arch}"], want[k * per:(k + 1) * per]), r
        for got, w in zip(out[f"decode/{arch}"], steps_want):
            assert torch.equal(got, w[k * per:(k + 1) * per]), r


def test_8bit_moments_on_gloo_ranks_equal_one_process(ranks, one_thread):
    """Two steps of 8-bit AdamW on reduced deepseek-v2: every rank's int8
    moments, row scales (a max over the group's ranks that hold a row,
    ``ShardMesh.pmax``) and bf16 second moments, loss and grad norm equal
    the one-process mesh's for that rank, bit for bit."""
    _, res = ranks
    _, opt, metrics = _train_8bit(_one_process(), lambda x: x)
    for r, out in enumerate(res):
        gm, gs, gv, gmetrics = out["train/q8"]
        for got, want in ((gm, opt.m.blocks[r]), (gs, opt.m_scale.blocks[r]),
                          (gv, opt.v.blocks[r])):
            assert all(torch.equal(a, b) for a, b in zip(_leaves(got), _leaves(want))), r
        assert all(torch.equal(a, b) for a, b in zip(gmetrics, metrics)), r


def _leaves(tree):
    return [t for _, t in tree_items(tree)]


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_train_steps_on_gloo_ranks_equal_one_process(ranks, setting, one_thread):
    """Every rank's parameter and moment blocks, loss and grad norm after two
    steps equal the one-process mesh's for the same rank, bit for bit."""
    _, res = ranks
    p, opt, metrics = _train(_one_process(), setting, lambda x: x)
    for r, out in enumerate(res):
        gp, gm, gv, gmetrics = out[f"train/{setting}"]
        for got, want in ((gp, p.blocks[r]), (gm, opt.m.blocks[r]), (gv, opt.v.blocks[r])):
            assert all(torch.equal(a, b) for a, b in zip(_leaves(got), _leaves(want))), r
        for (gl, gn), (wl, wn) in zip(gmetrics, metrics):
            assert torch.equal(gl, wl) and torch.equal(gn, wn), r


@pytest.mark.parametrize("shape", [(1, 1), (4, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_checkpoint_per_host_restores_onto_other_meshes(ranks, shape, one_thread):
    """Each rank wrote its own shard file; the whole tree they hold, restored
    onto another mesh and gathered, equals the one-process run's."""
    tmp, _ = ranks
    step_dir = tmp / "ckpt" / "step_00000001"
    assert sorted(f.name for f in step_dir.glob("shard_*.npz")) == \
        [f"shard_{r:05d}.npz" for r in range(WORLD)]
    p, opt, _ = _train(_one_process(), "plain", lambda x: x)
    want = {"params": unshard_params(p), "m": unshard_params(opt.m), "v": unshard_params(opt.v)}
    cfg = reduced(get_config("smollm-135m"))
    tmpl = lm.model_template(cfg)
    like = {"params": want["params"], "opt": opt._replace(m=want["m"], v=want["v"])}
    shardings = {"params": tmpl, "opt": opt._replace(step=None, m=opt.m.template,
                                                     v=opt.v.template)}
    back = restore_checkpoint(str(tmp / "ckpt"), 1, like,
                              mesh=ShardMesh(["cpu"] * (shape[0] * shape[1]), *shape),
                              shardings=shardings)
    got = {"params": unshard_params(back["params"]), "m": unshard_params(back["opt"].m),
           "v": unshard_params(back["opt"].v)}
    for key in want:
        assert all(torch.equal(a, b) for a, b in zip(_leaves(got[key]), _leaves(want[key])))
    assert int(back["opt"].step) == 2


def test_ranks_load_neither_jax_nor_repro(ranks):
    _, res = ranks
    assert all(out["jax_or_repro_modules"] == [] for out in res)
