"""The port's training mesh against the live JAX one-device train step on
the CPU: reduced fp32 qwen3-next-gdn and mixtral-8x7b, the reference's
parameters through the numpy bridge, four spawned gloo ranks
(``tests/torch_mesh_ranks.py``'s train jobs) training while the
reference runs here.

Layouts of qwen3-next-gdn, 3 steps each from the bridged initial state on
the loader's batches (bitwise the reference's): (2,1); (2,1) with FSDP
forced (``sharding.needs_fsdp`` patched inside the rank job: the reduced
configs never need it); (1,2), the Megatron pairs through gdn, attn, the
dense FFN, the vocab-parallel embedding and the LM head; (2,2) with FSDP
forced; one KV head on (1,2) (k and v split on head_dim, gathered
before RoPE).  Then (2,1) with 2 microbatches (each rank holds its
block of every microbatch), the factored second moments under forced
FSDP (their row and column means all-reduced over the split dims),
mixtral on (2,1) with FSDP forced (its one 64-token capacity group
spans both ranks' 32 tokens; ``aux`` and ``ce`` from the global batch),
the elastic restore of (2,1)'s step-2 checkpoint into one device and
into (1,2), the refusal of a model axis that does not divide ``ssm``'s
d_state (``fit_spec`` would move it: ROADMAP item 4g), the gradients' mean
over a data axis of 4 (``Axis.mean_flat``: FSDP's reduce-scatter against
the all-reduce and the cut), and the train state's specs against the
reference's ``Trainer._shardings``.

Tolerances: ``tests/test_torch_train.py``'s.  The loss and ``ce`` to 1e-5
relative, the grad norm to 1e-5, the moments like the gradients (1e-4
relative, 1e-6 absolute), the parameters to 1e-6 wherever the first
moment shows a gradient well above AdamW's eps and elsewhere within the
step's bound (``_assert_stepped_state``): the mesh changes only summation
orders (the data mean of the gradients in rank order, the model axis's
partial sums).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ranks as ranks                          # noqa: E402
from repro import configs as jconfigs                     # noqa: E402
from repro.data import pipeline as jdata                  # noqa: E402
from repro.optim import optimizers as jopt                # noqa: E402
from repro.parallel import sharding as jrules             # noqa: E402
from repro.runtime import trainer as jtrainer             # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_numpy, to_torch         # noqa: E402
from repro_torch.optim import optimizers as topt          # noqa: E402
from repro_torch.parallel import sharding as trules       # noqa: E402
from repro_torch.runtime import trainer as ttrainer       # noqa: E402
from repro_torch.tree import leaves, tree_map_with_path   # noqa: E402

STEP = dict(rtol=1e-6, atol=1e-6)
LOSS = dict(rtol=1e-5, atol=0)
GRAD = dict(rtol=1e-4, atol=1e-6)

ARCH, MOE = "qwen3-next-gdn", "mixtral-8x7b"
# test_torch_train.py's schedule: warmup over 2 steps (lr 0, peak / 2,
# peak), so steps 2 and 3 update the parameters.  Without warmup one
# w_alpha element of the one-device port's own second step leaves the
# reference's by 1.4e-5 relative, past the rule's 1e-6, at B 4
# (ROADMAP.md queue 3).
TC = dict(steps=3, seq_len=32, global_batch=4, peak_lr=1e-3,
          warmup_steps=2)
FACTORED = dict(factored=True)
# name -> (mesh, FSDP forced, TrainerConfig settings over TC)
LAYOUTS = {"2x1": ((2, 1), False, {}),
           "2x1_fsdp": ((2, 1), True, {}),
           "1x2": ((1, 2), False, {}),
           "2x2_fsdp": ((2, 2), True, {})}
VARIANTS = {"2x1_mb2": ((2, 1), False, dict(microbatches=2)),
            "2x1_factored_fsdp": ((2, 1), True, dict(adamw=FACTORED))}
MOE_TC = dict(TC, global_batch=2)


def _jcfg(arch):
    """The reference's reduced config of ``arch`` or of a name of
    ``ranks.VARIANTS``."""
    base, kw = ranks.VARIANTS.get(arch, (arch, {}))
    return jconfigs.get_arch(base).reduced().replace(**kw)


def _jrun(arch, tc, steps):
    """The reference's one-device trainer state and step on the loader's
    batches: (initial state as the port's numpy tree, [(state, metrics)]
    after each step)."""
    jcfg = _jcfg(arch)
    kw = dict(tc)
    if "adamw" in kw:
        kw["adamw"] = jopt.AdamWConfig(**kw["adamw"])
    jtc = jtrainer.TrainerConfig(**kw)
    state = jax.jit(lambda key: jtrainer.init_state(key, jcfg, jtc))(
        jax.random.PRNGKey(0))
    init = to_numpy(to_torch(jax.tree.map(np.asarray, state)))
    loader = jdata.HostDataLoader(jdata.DataConfig(
        vocab=jcfg.vocab, seq_len=jtc.seq_len,
        global_batch=jtc.global_batch, seed=jtc.seed))
    step = jax.jit(jtrainer.build_train_step(jcfg, jtc))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    out = []
    for s in range(steps):
        with mesh:
            state, m = step(state, jax.tree.map(jnp.asarray,
                                                loader.batch_at(s)))
        out.append((state, {k: float(v) for k, v in m.items()}))
    return init, out


def _job(name, mesh, fsdp, tc, arch=ARCH, init="base", **kw):
    return dict(name=name, kind="train", mesh=mesh, arch=arch, fsdp=fsdp,
                tc=dict(TC, **tc), steps=3, init=init, **kw)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's runs and the ranks' results: {job name: {rank:
    result}}, the reference's {config: (init, steps)} and the checkpoint
    directory of (2,1)'s step 2."""
    torch.set_num_threads(1)
    ckdir = str(tmp_path_factory.mktemp("mesh_ckpt"))
    ref = {"base": _jrun(ARCH, TC, 3)}
    jobs = [_job(n, m, f, tc, save=ckdir if n == "2x1" else None, save_at=2)
            for n, (m, f, tc) in LAYOUTS.items()]
    jobs += [_job(n, m, f, tc, init=n) for n, (m, f, tc) in VARIANTS.items()]
    jobs += [_job("moe_2x1", (2, 1), True, MOE_TC, arch=MOE, init="moe"),
             _job("mqa_1x2", (1, 2), False, {}, arch=ranks.MQA, init="mqa"),
             dict(_job("resume_1x2", (1, 2), False, {}), steps=1,
                  restore=ckdir),
             dict(name="refuse_ssm", kind="refuse", mesh=(1, 2),
                  arch=ranks.SSM_ODD),
             dict(name="mean_flat", kind="mean_flat", mesh=(4, 1))]
    for n, (_, _, tc) in VARIANTS.items():
        ref[n] = _jrun(ARCH, dict(TC, **tc), 3)
    ref["moe"] = _jrun(MOE, MOE_TC, 3)
    ref["mqa"] = _jrun(ranks.MQA, TC, 3)
    # each run's initial state (the factored moments' tree differs)
    shared = {"train": {k: v[0] for k, v in ref.items()}}
    out = ranks.start(4, jobs, shared).results()
    for r, res in out.items():
        for name, v in res.items():
            assert "error" not in v, f"rank {r}, {name}:\n{v['error']}"
    by_job = {}
    for r, res in out.items():
        for name, v in res.items():
            by_job.setdefault(name, {})[r] = v
    return by_job, ref, ckdir


def _assert_trees(t_tree, j_tree, **tol):
    tl = leaves(t_tree)
    jl = jax.tree.leaves(jax.tree.map(np.asarray, j_tree))
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), **tol)


def _first_moments(jstate):
    return [np.asarray(s["m"]) if "m" in s else None for s in
            jax.tree.leaves(jstate["opt"]["mu"], is_leaf=lambda x: isinstance(
                x, dict) and ("v" in x or "v_row" in x))]


def _assert_stepped_state(tnew, jnew, tc, history=()):
    """``tests/test_torch_train.py``'s rule: moments like the gradients;
    parameters tight where the gradient is well above AdamW's eps;
    elsewhere bounded by lr (1 + weight decay |p|).  ``history``: the
    reference's states after the earlier steps that moved the parameters
    (lr > 0); an element is then held tight only where its first moment
    is well above eps after each of them too (an update at eps's scale is
    ill-conditioned, and a later large gradient hides it in the final
    moment: ROADMAP queue 3)."""
    _assert_trees(tnew["opt"]["mu"], jnew["opt"]["mu"], **GRAD)
    tp = leaves(tnew["params"])
    jp = jax.tree.leaves(jax.tree.map(np.asarray, jnew["params"]))
    jmu = _first_moments(jnew)
    earlier = [_first_moments(h) for h in history]
    assert len(tp) == len(jp) == len(jmu)
    for i, (a, b, m) in enumerate(zip(tp, jp, jmu)):
        sharp = np.abs(m) / (1 - tc.adamw.b1) > 1e-6
        for mu in earlier:
            sharp &= np.abs(mu[i]) / (1 - tc.adamw.b1) > 1e-6
        np.testing.assert_allclose(a[sharp], b[sharp], **STEP)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)
    assert int(tnew["step"]) == int(jnew["step"])
    assert int(tnew["opt"]["count"]) == int(jnew["opt"]["count"])


def _check(got, want, tc, every_step=False):
    """Every rank's per-step metrics equal (the mesh's ranks agree bit for
    bit); rank 0's against the reference's steps; its whole final state
    by the stepped-state rule (``every_step``: with the sharp mask of
    every step that moved the parameters)."""
    ms = [g["metrics"] for g in got.values()]
    assert all(m == ms[0] for m in ms)
    assert len(ms[0]) == len(want)
    for m, (_, jm) in zip(ms[0], want):
        for k in ("loss", "ce"):
            np.testing.assert_allclose(m[k], jm[k], **LOSS)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=1e-5)
        np.testing.assert_allclose(m["lr"], jm["lr"], rtol=1e-6)
    history = [st for st, jm in want[:-1] if jm["lr"] > 0] \
        if every_step else ()
    _assert_stepped_state(got[0]["state"], want[-1][0], tc, history)


def _jtc(tc):
    kw = dict(TC, **tc)
    if "adamw" in kw:
        kw["adamw"] = jopt.AdamWConfig(**kw["adamw"])
    return jtrainer.TrainerConfig(**kw)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_trains_as_the_reference(run, name):
    jobs, ref, _ = run
    _check(jobs[name], ref["base"][1], _jtc({}))


@pytest.mark.parametrize("name", sorted(LAYOUTS) + sorted(VARIANTS))
def test_each_rank_holds_the_specs_shards(run, name):
    """Each rank's parameter and moment shapes are those
    ``params_specs`` and ``opt_moment_specs`` give (FSDP as forced or by
    the reference's rule: off at the reduced width), and a layout that
    splits a leaf holds less than the whole of it."""
    jobs, _, _ = run
    mesh, fsdp, _ = {**LAYOUTS, **VARIANTS}[name]
    for r, got in jobs[name].items():
        assert got["fsdp"] is fsdp
        bad = [(p, a, b) for p, a, b, _ in got["shapes"] if a != b]
        assert not bad, (r, bad[:3])
        split = [p for p, a, _, w in got["shapes"] if a != w]
        # the data axis alone splits nothing without FSDP
        assert bool(split) == (fsdp or mesh[1] > 1), (r, split[:3])
    shapes = {p: s for p, s, _, _ in jobs[name][0]["shapes"]}
    # a GDN layer's wq (1, 64, 2, 16): its rows on "data" under FSDP,
    # its k heads on "model"
    assert shapes["params/groups/0/0/mixer/wq"] == (
        1, 64 // mesh[0] if fsdp else 64, 2 // mesh[1], 16)


def test_microbatches_train_as_the_reference(run):
    jobs, ref, _ = run
    _check(jobs["2x1_mb2"], ref["2x1_mb2"][1], _jtc(VARIANTS["2x1_mb2"][2]))


def test_factored_moments_under_fsdp(run):
    """The factored ``v_row`` / ``v_col`` on FSDP-split parameters: their
    means all-reduce over the split dims, and they keep the rows and
    columns of the rank's block."""
    jobs, ref, _ = run
    name = "2x1_factored_fsdp"
    _check(jobs[name], ref[name][1], _jtc(VARIANTS[name][2]))
    shapes = {p: s for p, s, _, _ in jobs[name][0]["shapes"]}
    # wi_gate (1, 64, 128) split (None, data, None): v_row keeps the
    # rank's 32 rows, v_col every column
    mu = "opt/mu/groups/0/0/mlp/wi_gate"
    assert shapes[f"{mu}/v_row"] == (1, 32)
    assert shapes[f"{mu}/v_col"] == (1, 128)


def test_moe_aux_and_ce_over_the_global_batch(run):
    """Mixtral on (2,1) with FSDP forced (the experts' d_model rows split
    on "data"): one capacity group of 64 tokens spans both ranks' 32; the
    aux loss and ce equal the one-device step's."""
    jobs, ref, _ = run
    got = jobs["moe_2x1"]
    for m, (_, jm) in zip(got[0]["metrics"], ref["moe"][1]):
        assert m["aux"] > 0
        np.testing.assert_allclose(m["aux"], jm["aux"], **LOSS)
        np.testing.assert_allclose(m["ce"], jm["ce"], **LOSS)
    _check(got, ref["moe"][1], jtrainer.TrainerConfig(**MOE_TC))


def test_kv_heads_split_on_head_dim(run):
    """One KV head on (1,2): ``fit_spec`` splits wk and wv on head_dim;
    k and v are gathered along it before RoPE (their gradient is the
    rank's block), each rank keeping the KV head of its query heads."""
    jobs, ref, _ = run
    got = jobs["mqa_1x2"]
    shapes = {p: s for p, s, _, _ in got[0]["shapes"]}
    assert shapes["params/groups/0/3/mixer/wk"] == (1, 64, 1, 8)
    assert shapes["params/groups/0/3/mixer/wq"] == (1, 64, 2, 16)
    _check(got, ref["mqa"][1], _jtc({}))


def test_grad_norm_at_2x2_is_the_one_device_norm(run):
    """Each element counts once: the leaves replicated over "model" are
    not summed once per model rank, the FSDP blocks over "data" are."""
    jobs, ref, _ = run
    for m, (_, jm) in zip(jobs["2x2_fsdp"][0]["metrics"], ref["base"][1]):
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=1e-5)


@pytest.mark.parametrize("target", ["one_device", "1x2"])
def test_elastic_restore(run, target):
    """(2,1)'s checkpoint after step 2 (whole leaves, written by rank 0)
    resumes on one device and on (1,2); step 3 on either is the
    reference's step 3."""
    jobs, ref, ckdir = run
    want = ref["base"][1]
    if target == "1x2":
        got = jobs["resume_1x2"]
        assert got[0]["start"] == 2
        _check(got, want[2:3], _jtc({}))
        return
    cfg = ranks.config(ARCH)
    tr = ttrainer.Trainer(cfg, ttrainer.TrainerConfig(
        **dict(TC, ckpt_dir=ckdir, ckpt_every=1000, log_every=1)),
        device="cpu")
    hist = tr.run()
    assert [s for s, _ in hist] == [3]
    np.testing.assert_allclose(hist[0][1], want[2][1]["loss"], **LOSS)
    _assert_stepped_state(to_numpy(tr.state), want[2][0], _jtc({}))


def test_mean_flat_is_the_cut_all_reduce(run):
    """The gradients' mean over a data axis of 4: the blocks of the split
    tensors (FSDP's reduce-scatter) and the whole others bit for bit what
    the all-reduce and the cut give."""
    jobs, _, _ = run
    assert len(jobs["mean_flat"]) == 4
    for r, got in jobs["mean_flat"].items():
        assert all(got["equal"]), (r, got["equal"])


def test_model_axis_refused_for_ssm(run):
    """Every kind trains on a model axis (``test_torch_mesh_train_kinds``);
    what is refused is an axis that does not divide a dim whose move the
    model code does not follow, here ssm's d_state of 33 at (1,2), naming
    the item that would follow ``fit_spec``'s move."""
    jobs, _, _ = run
    got = jobs["refuse_ssm"][0]
    assert got["type"] == "ValueError"
    assert "ssm_d_state" in got["message"]
    assert "item 4g" in got["message"]


def _flat_specs(tree, jax_side):
    """{path: spec entries} of a spec tree (a one-axis tuple entry as its
    name, as jax writes it)."""
    def entry(e):
        return e[0] if isinstance(e, (list, tuple)) and len(e) == 1 else e
    out = {}
    if jax_side:
        flat, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for p, spec in flat:
            out[jrules.path_str(p)] = tuple(entry(e) for e in spec)
        return out

    def put(path, spec):
        out[trules.path_str(path)] = tuple(entry(e) for e in spec)
    tree_map_with_path(put, tree)
    return out


@pytest.mark.parametrize("factored", [False, True])
def test_train_state_specs_against_the_reference(factored):
    """The train state's specs on a (2,2) stand-in mesh with FSDP: params,
    ``m``, ``v`` and ``v_row`` as the reference's ``Trainer._shardings``
    places them; ``v_col`` without the entry of the dim it reduces (the
    reference keeps the spec's leading entries, which puts its last dim
    under the reduced dim's entry: GSPMD reshards it)."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 2, "model": 2})
    jcfg = _jcfg(ARCH)
    jtc = jtrainer.TrainerConfig(adamw=jopt.AdamWConfig(factored=factored))
    jstate = jax.eval_shape(lambda: jtrainer.init_state(
        jax.random.PRNGKey(0), jcfg, jtc))
    jp = jrules.params_specs(jcfg, jstate["params"], True, mesh)
    want = _flat_specs(jtrainer.opt_moment_specs(jstate["opt"]["mu"], jp),
                       True)
    tcfg = tconfigs.get_arch(ARCH).reduced()
    ttc = ttrainer.TrainerConfig(adamw=topt.AdamWConfig(factored=factored))
    tstate = ttrainer.init_state(None, tcfg, ttc, "meta")
    specs = trules.train_state_specs(tcfg, tstate, True, mesh)
    got = _flat_specs(specs["opt"]["mu"], False)
    assert _flat_specs(specs["params"], False) == _flat_specs(jp, True)
    assert specs["opt"]["count"] == specs["step"] == trules.P()
    assert sorted(got) == sorted(want)
    pspecs = _flat_specs(specs["params"], False)
    cols = 0
    for path, spec in got.items():
        if path.endswith("/v_col"):
            p = pspecs[path[:-len("/v_col")]]
            p = p + (None,) * (len(spec) + 1 - len(p))
            assert spec == p[:-2] + p[-1:], path
            cols += 1
        else:
            assert spec == want[path], path
    assert (cols > 0) == factored
