"""The port's training path against the JAX reference on the CPU: schedules,
every AdamW branch, the loader, checkpoints across the two packages,
``loss_fn`` (flash kernel path on and off) and one ``build_train_step``
step on reduced fp32 qwen3-next-gdn, and the trainer's behaviours
(``tests/test_substrate.py``'s trainer tests, on the port).  Parameters
and states come from the reference through the numpy bridge; inputs are
made with numpy from a seed.

Tolerances: fp32 throughout.  One AdamW step on the same inputs differs
only in summation order, 1e-6.  The reduced LM's loss agrees to 1e-5
relative and its gradients to 1e-4 relative with an absolute floor of
1e-6 (sums over B*T positions and the chunkwise recurrence); with
``use_flash_kernel`` the reference runs its Pallas kernels in interpret
mode and the port their dense plain versions.  After one train step the
moments agree like the gradients, and the parameters to 1e-6 wherever
|g| > 1e-6: the first AdamW update is g / (|g| + eps), whose slope near
|g| ~ eps = 1e-8 magnifies a gradient's last-bit difference, so there
the step is only held to its bound, 2 lr.  Loader batches and
checkpoints are bitwise.

The compiled step: the schedules' tensor form (a 0-d step on the device)
against the reference's, three consecutive steps through the warmup
against the jitted reference step with the tolerances above, the step
under ``tests/torch_host_guard.py`` (no host data and no host read after
its first call: what a CUDA graph capture refuses on the card), the static
batch buffers, and a failed capture raising instead of running eagerly.
"""
import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                     # noqa: E402
from repro.checkpoint import manager as jckpt              # noqa: E402
from repro.data import pipeline as jdata                   # noqa: E402
from repro.models import lm as jlm                         # noqa: E402
from repro.optim import optimizers as jopt                 # noqa: E402
from repro.runtime import trainer as jtrainer              # noqa: E402
from repro_torch import configs as tconfigs                # noqa: E402
from repro_torch.bridge import to_numpy, to_torch          # noqa: E402
from repro_torch.checkpoint import manager as tckpt        # noqa: E402
from repro_torch.data import pipeline as tdata             # noqa: E402
from repro_torch.models import lm as tlm                   # noqa: E402
from repro_torch.optim import optimizers as topt           # noqa: E402
from repro_torch.parallel import sharding as trules        # noqa: E402
from repro_torch.runtime import trainer as ttrainer        # noqa: E402
from repro_torch.runtime import graphs                     # noqa: E402
from repro_torch.tree import leaves                        # noqa: E402
from torch_host_guard import guard_programs                # noqa: E402

STEP = dict(rtol=1e-6, atol=1e-6)
LOSS = dict(rtol=1e-5, atol=0)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _cfgs(flash=False):
    j = jconfigs.get_arch("qwen3-next-gdn").reduced()
    t = tconfigs.get_arch("qwen3-next-gdn").reduced()
    return (j.replace(use_flash_kernel=flash),
            t.replace(use_flash_kernel=flash))


def _batch(cfg, B=2, T=32, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, cfg.vocab, size=(B, T + 1)).astype(np.int32)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _assert_trees(t_tree, j_tree, **tol):
    tl = leaves(to_numpy(t_tree))
    jl = jax.tree.leaves(jax.tree.map(np.asarray, j_tree))
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), **tol)


# ------------------------------------------------------------ schedules

@pytest.mark.parametrize("kind", ["cosine", "wsd"])
def test_schedules_match_reference(kind):
    if kind == "cosine":
        j, t = (m.cosine_schedule(3e-4, 10, 100) for m in (jopt, topt))
    else:
        j, t = (m.wsd_schedule(1e-3, 5, 20, 10) for m in (jopt, topt))
    for step in [0, 1, 4, 5, 9, 10, 11, 24, 30, 35, 50, 99, 100, 150]:
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6)


@pytest.mark.parametrize("kind", ["cosine", "wsd"])
def test_schedules_on_the_device_match_reference(kind):
    """The tensor form: a 0-d int32 step gives a 0-d fp32 lr computed with
    the reference's branches, over warmup, the stable or cosine part, the
    decay and past the end."""
    if kind == "cosine":
        j, t = (m.cosine_schedule(3e-4, 10, 100) for m in (jopt, topt))
    else:
        j, t = (m.wsd_schedule(1e-3, 5, 20, 10) for m in (jopt, topt))
    for step in [0, 1, 4, 5, 9, 10, 11, 24, 30, 35, 50, 99, 100, 150]:
        got = t(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(j(jnp.int32(step))),
                                   rtol=1e-6)


# ------------------------------------------------------------ AdamW

ADAMW = {
    "fp32": jopt.AdamWConfig(),
    "bf16_ef": jopt.AdamWConfig(moment_dtype="bfloat16"),
    "factored": jopt.AdamWConfig(factored=True),
    "no_momentum": jopt.AdamWConfig(momentum=False, factored=True),
    "clipped": jopt.AdamWConfig(clip_norm=0.05),
}


@pytest.mark.parametrize("name", sorted(ADAMW))
def test_adamw_update_matches_reference(name):
    """Two AdamW steps on a tree of a stacked 3-D, a 2-D and a 1-D leaf;
    the port writes params and moments in place."""
    jcfg = ADAMW[name]
    tcfg = topt.AdamWConfig(**jcfg._asdict())
    rng = np.random.default_rng(3)
    shapes = {"w3": (2, 6, 5), "w2": (4, 3), "b": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_adamw(jp, jcfg)
    tp = to_torch(params)
    ts = topt.init_adamw(tp, tcfg)
    _assert_trees(ts, js, rtol=0, atol=0)
    for step in range(2):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        jp, js, jn = jopt.adamw_update(jax.tree.map(jnp.asarray, grads), js,
                                       jp, 1e-2 * (step + 1), jcfg)
        tp2, ts2, tn = topt.adamw_update(to_torch(grads), ts, tp,
                                         1e-2 * (step + 1), tcfg)
        assert tp2 is tp and ts2 is ts            # updated in place
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_trees(tp, jp, **STEP)
        _assert_trees(ts, js, **STEP)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(4)
    g = {"a": rng.normal(size=(3, 4)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tc, tn = topt.clip_by_global_norm(to_torch(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_trees(tc, jc, **STEP)


# ------------------------------------------------------------ data

def test_loader_batches_bitwise():
    kw = dict(vocab=1000, seq_len=64, global_batch=8, seed=7)
    for host in range(2):
        j = jdata.HostDataLoader(jdata.DataConfig(**kw), host, 2)
        t = tdata.HostDataLoader(tdata.DataConfig(**kw), host, 2)
        for step in (0, 3):
            jb, tb = j.batch_at(step), t.batch_at(step)
            for k in ("tokens", "labels"):
                assert jb[k].dtype == tb[k].dtype
                assert jb[k].tobytes() == tb[k].tobytes()
    t = tdata.HostDataLoader(tdata.DataConfig(**kw))
    t.start(2)
    s, b = t.next()
    assert s == 2
    assert b["tokens"].tobytes() == j.__class__(
        jdata.DataConfig(**kw)).batch_at(2)["tokens"].tobytes()


# ------------------------------------------------------------ checkpoints

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_across_packages(tmp_path, writer):
    """A bf16 train state written by one package's CheckpointManager
    restores bitwise in the other's."""
    jcfg = jconfigs.get_arch("qwen3-next-gdn").reduced().replace(
        act_dtype="bfloat16")
    tc = jtrainer.TrainerConfig(adamw=jopt.AdamWConfig(
        moment_dtype="bfloat16"))
    state = jax.jit(lambda key: jax.tree.map(
        lambda a: a + jnp.ones_like(a), jtrainer.init_state(key, jcfg, tc)))(
            jax.random.PRNGKey(2))
    np_state = jax.tree.map(np.asarray, state)
    if writer == "jax":
        jckpt.CheckpointManager(str(tmp_path)).save(state, 5)
        mgr = tckpt.CheckpointManager(str(tmp_path))
        got, step = mgr.restore_latest(to_torch(np_state))
        got = leaves(to_numpy(got))
    else:
        mgr = tckpt.CheckpointManager(str(tmp_path))
        mgr.save(to_torch(np_state), 5, blocking=False)
        mgr.wait()
        got, step = jckpt.CheckpointManager(str(tmp_path)).restore_latest(
            np_state)
        got = jax.tree.leaves(got)
    assert step == 5
    want = jax.tree.leaves(np_state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_checkpoint_manager_gc_and_partial(tmp_path):
    m = tckpt.CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    for s in (10, 20, 30):
        m.save(tree, s, blocking=False)
    m.wait()
    assert tckpt.completed_steps(str(tmp_path)) == [20, 30]
    (tmp_path / "step_000000040").mkdir()          # a crashed save
    assert m.latest_step() == 30
    got, step = m.restore_latest(tree)
    assert step == 30 and torch.equal(got["w"], tree["w"])


# ------------------------------------------------------------ loss and step

@pytest.fixture(scope="module")
def jstate():
    jcfg, _ = _cfgs()
    tc = jtrainer.TrainerConfig()
    return jax.jit(lambda key: jtrainer.init_state(key, jcfg, tc))(
        jax.random.PRNGKey(0))


@pytest.mark.parametrize("flash", [False, True])
def test_loss_fn_and_grads_match_reference(jstate, flash):
    jcfg, tcfg = _cfgs(flash)
    batch = _batch(jcfg)
    jparams = jstate["params"]

    def jloss(p):
        return jlm.loss_fn(p, jcfg, jax.tree.map(jnp.asarray, batch),
                           dp_axes=None)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    tparams = to_torch(jax.tree.map(np.asarray, jparams))
    plist = leaves(tparams)
    for p in plist:
        p.requires_grad_(True)
    tl, tm = tlm.loss_fn(tparams, tcfg, _tb(batch))
    # loss_fn applies no final norm (as the reference): its grad is zero
    tg = [torch.zeros_like(p) if g is None else g for p, g in zip(
        plist, torch.autograd.grad(tl, plist, allow_unused=True))]
    tl, tm = tl.detach(), {k: v.detach() for k, v in tm.items()}
    np.testing.assert_allclose(float(tl), float(jl), **LOSS)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), **LOSS)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    jgl = jax.tree.leaves(jg)
    assert len(tg) == len(jgl)
    for a, b in zip(tg, jgl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


def test_train_step_matches_reference(jstate):
    jcfg, tcfg = _cfgs()
    tc = jtrainer.TrainerConfig(peak_lr=1e-3, warmup_steps=0)
    batch = _batch(jcfg, seed=1)
    tstate = to_torch(jax.tree.map(np.asarray, jstate))
    with _mesh():
        jnew, jm = jax.jit(jtrainer.build_train_step(jcfg, tc))(
            jstate, jax.tree.map(jnp.asarray, batch))
    ttc = ttrainer.TrainerConfig(peak_lr=1e-3, warmup_steps=0)
    tnew, tm = ttrainer.build_train_step(tcfg, ttc)(tstate, _tb(batch))
    assert tnew is tstate
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    assert int(tnew["opt"]["count"]) == int(jnew["opt"]["count"]) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    _assert_stepped_state(tnew, jnew, tc)


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _assert_stepped_state(tnew, jnew, tc):
    """Moments like the gradients; parameters tight where the gradient is
    well above AdamW's eps; elsewhere the step g / (|g| + eps) is
    ill-conditioned and only bounded by lr (1 + weight decay |p|)."""
    _assert_trees(tnew["opt"]["mu"], jnew["opt"]["mu"], **GRAD)
    tp, jp = leaves(to_numpy(tnew["params"])), jax.tree.leaves(
        jax.tree.map(np.asarray, jnew["params"]))
    jmu = [np.asarray(s["m"]) for s in jax.tree.leaves(
        jnew["opt"]["mu"], is_leaf=lambda x: isinstance(x, dict)
        and "m" in x)]
    assert len(tp) == len(jp) == len(jmu)
    for a, b, m in zip(tp, jp, jmu):
        sharp = np.abs(m) / (1 - tc.adamw.b1) > 1e-6
        np.testing.assert_allclose(a[sharp], b[sharp], **STEP)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)


def test_train_steps_through_warmup_match_reference(jstate):
    """Three consecutive steps of ``build_train_step`` with warmup_steps=2
    (lr 0, peak / 2, then the cosine's peak), the lr and AdamW's bias
    corrections taken on the device from the step and the count, against
    the jitted reference step applied three times: the count passes 1 and
    the warmup branch is held, with the tolerances of one step."""
    jcfg, tcfg = _cfgs()
    tc = jtrainer.TrainerConfig(peak_lr=1e-3, warmup_steps=2)
    jstep = jax.jit(jtrainer.build_train_step(jcfg, tc))
    tstep = ttrainer.build_train_step(
        tcfg, ttrainer.TrainerConfig(peak_lr=1e-3, warmup_steps=2))
    jnew, tnew = jstate, to_torch(jax.tree.map(np.asarray, jstate))
    for i in range(3):
        batch = _batch(jcfg, seed=10 + i)
        with _mesh():
            jnew, jm = jstep(jnew, jax.tree.map(jnp.asarray, batch))
        tnew, tm = tstep(tnew, _tb(batch))
        assert isinstance(tm["lr"], torch.Tensor)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **LOSS)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert float(jm["lr"]) == pytest.approx(1e-3)
    assert int(tnew["step"]) == int(jnew["step"]) == 3
    assert int(tnew["opt"]["count"]) == int(jnew["opt"]["count"]) == 3
    _assert_stepped_state(tnew, jnew, tc)


# ------------------------------------------------------------ trainer

def _tiny_trainer(tmp_path, **kw):
    cfg = tconfigs.get_arch("qwen3-next-gdn").reduced()
    tc = ttrainer.TrainerConfig(steps=6, seq_len=32, global_batch=2,
                                peak_lr=1e-3, warmup_steps=2,
                                ckpt_dir=str(tmp_path), ckpt_every=2,
                                ckpt_async=False, log_every=2, **kw)
    return ttrainer.Trainer(cfg, tc, device="cpu")


def test_trainer_loss_decreases(tmp_path):
    t = _tiny_trainer(tmp_path)
    hist = t.run()
    assert [s for s, _ in hist] == [2, 4, 6]
    assert hist[-1][1] < hist[0][1]
    assert len(t.step_times) == 6


def test_trainer_failure_recovery(tmp_path, caplog):
    t = _tiny_trainer(tmp_path)
    with caplog.at_level(logging.WARNING):
        hist = t.run(fail_at=4)
    assert t.restarts == 1
    assert hist[-1][0] == 6                       # completed despite fault
    assert any("restoring" in r.message for r in caplog.records)
    # the restored run replays steps 4-5 from the step-4 checkpoint and
    # ends where an unbroken run ends
    ref = _tiny_trainer(tmp_path / "ref")
    ref.run()
    for a, b in zip(leaves(t.state["params"]), leaves(ref.state["params"])):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())


def test_trainer_resume_from_checkpoint(tmp_path):
    t = _tiny_trainer(tmp_path)
    t.run()
    t2 = _tiny_trainer(tmp_path)
    t2.compile()
    assert t2._maybe_restore() == 6
    for a, b in zip(leaves(t2.state), leaves(t.state)):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy())
    assert t2.run() == []                          # nothing left to do


def test_trainer_microbatch_accumulation():
    """Two microbatches of one row give the loss and the update of one
    batch of two rows (equal-size slices: the mean of means)."""
    cfg = tconfigs.get_arch("qwen3-next-gdn").reduced()
    out = []
    for mb in (1, 2):
        tc = ttrainer.TrainerConfig(steps=2, seq_len=32, global_batch=2,
                                    microbatches=mb, schedule="wsd")
        t = ttrainer.Trainer(cfg, tc, device="cpu")
        hist = t.run()
        assert hist[-1][0] == 2
        out.append((hist[-1][1], leaves(t.state["params"])))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_trainer_rejects_a_mesh():
    """The refusal that remains: a model axis that ``fit_spec`` moves
    onto a dim whose move the model code does not follow (ROADMAP item
    4g: here the SSD heads and the RG-LRU width), checked from the mesh's
    shape before any process group is touched; the moves it follows
    pass the check (query heads onto head_dim, the experts onto d_ff,
    with and without FSDP)."""
    def mesh(model):
        return SimpleNamespace(axis_names=("data", "model"),
                               shape={"data": 1, "model": model})
    for arch, model, what in (("mamba2-1.3b", 3, "ssm_heads"),
                              ("recurrentgemma-2b", 3, "rglru_width")):
        cfg = tconfigs.get_arch(arch).reduced()
        with pytest.raises(ValueError,
                           match=rf"{what}.*ROADMAP queue 1 item 4g"):
            ttrainer.Trainer(cfg, ttrainer.TrainerConfig(),
                             mesh=mesh(model), device="cpu")
    for arch in ("h2o-danube-1.8b", "mixtral-8x7b", "arctic-480b"):
        cfg = tconfigs.get_arch(arch).reduced()
        for fsdp in (False, True):
            trules.check_model_axis(cfg, 8, None, 1, fsdp)


@pytest.mark.parametrize("arch,schedule", [("minicpm-2b", "wsd"),
                                           ("qwen3-next-gdn", "cosine")])
def test_train_cli_schedule(monkeypatch, arch, schedule):
    """The train CLI trains minicpm-2b on WSD whatever ``--schedule``
    says, as the reference's CLI does (its paper's schedule); other
    archs take the flag's default, cosine."""
    from repro_torch.launch import train as tcli
    made = []

    class Stub:
        axes = None

        def __init__(self, cfg, tc, **kw):
            made.append(tc)

        def run(self):
            return []

    monkeypatch.setattr(tcli, "Trainer", Stub)
    tcli.main(["--arch", arch, "--device", "cpu", "--steps", "1"])
    assert [tc.schedule for tc in made] == [schedule]


# ------------------------------------------------------------ compiled step

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_stays_on_the_device_after_its_first_call(monkeypatch,
                                                             microbatches):
    """The trainer's step program, from its second call on, makes no
    tensor from host data and reads nothing on the host (what a CUDA graph
    capture refuses on the card), with and without microbatches."""
    calls = guard_programs(monkeypatch)
    cfg = tconfigs.get_arch("qwen3-next-gdn").reduced()
    tc = ttrainer.TrainerConfig(steps=3, seq_len=32, global_batch=2,
                                microbatches=microbatches, warmup_steps=2,
                                log_every=1)
    t = ttrainer.Trainer(cfg, tc, device="cpu")
    hist = t.run()
    assert calls["guarded"] == 2
    assert [s for s, _ in hist] == [1, 2, 3]
    assert [r["lr"] for r in t.logged] == pytest.approx(
        [0.0, tc.peak_lr / 2, tc.peak_lr])
    assert int(t.state["step"]) == int(t.state["opt"]["count"]) == 3


def test_trainer_batch_fills_the_same_buffers():
    """``Trainer.batch`` copies the loader's batch into the static int64
    buffers the step program reads: the same tensors every step."""
    cfg = tconfigs.get_arch("qwen3-next-gdn").reduced()
    tc = ttrainer.TrainerConfig(seq_len=32, global_batch=2)
    t = ttrainer.Trainer(cfg, tc, device="cpu").compile()
    b0 = t.batch(0)
    ptrs = {k: v.data_ptr() for k, v in b0.items()}
    first = {k: v.clone() for k, v in b0.items()}
    b1 = t.batch(1)
    assert b1 is b0 and {k: v.data_ptr() for k, v in b1.items()} == ptrs
    want = t.loader.batch_at(1)
    assert sorted(b1) == sorted(want) == ["labels", "tokens"]
    for k, v in b1.items():
        assert v.dtype == torch.int64 and tuple(v.shape) == (2, 32)
        np.testing.assert_array_equal(v.numpy(), want[k])
        assert not torch.equal(v, first[k])


def test_trainer_graph_failure_raises_without_an_eager_retry(tmp_path,
                                                             monkeypatch):
    """A capture that fails raises out of ``run`` as ``GraphStepError``: no
    restart, and no eager step in its place (on the CPU the program is
    given a pool, so that its second call captures, as on the card)."""
    def refuse(prog):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(graphs.Program, "_capture", refuse)
    t = _tiny_trainer(tmp_path).compile()
    t.program.pool = object()
    with pytest.raises(ttrainer.GraphStepError, match="capturing"):
        t.run()
    assert t.restarts == 0 and t.program.calls == 2
    assert len(t.step_times) == 1 and int(t.state["step"]) == 1


def test_trainer_without_a_card_raises(monkeypatch):
    """No fallback: the trainer's default device is the card, and graphs
    need one."""
    cfg = tconfigs.get_arch("qwen3-next-gdn").reduced()
    with pytest.raises(ValueError, match="cuda_graphs=True needs a CUDA"):
        ttrainer.Trainer(cfg, ttrainer.TrainerConfig(), device="cpu",
                         cuda_graphs=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.Trainer(cfg, ttrainer.TrainerConfig())
