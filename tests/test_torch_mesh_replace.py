"""The moves of the model axis that the reference's ``fit_spec`` makes
where the axis does not divide the dim its rule names, followed by the
port's model code, against the live JAX reference on the CPU: reduced
fp32 configs ``.replace``d so that a model axis of 2 moves as the full
width moves at 16 (or, for minicpm-2b, at every size), two spawned gloo
ranks (``tests/torch_mesh_ranks.py``) serving and training while the
reference runs here.

  * minicpm-2b, vocab 257 (tied): the table on d_model, the logits
    row-parallel; under FSDP (forced) the table replicated over "model";
  * mamba2-1.3b, vocab 257: the table and the untied head on d_model;
  * mixtral-8x7b, 3 experts: the experts on d_ff, ``wo`` on d_model (on
    d_ff under FSDP, forced);
  * arctic-480b, 3 query heads and 1 KV head: q, k and v on head_dim,
    ``wo`` on d_model (on head_dim under FSDP, forced).

For each: the port's ``params_specs`` equal the reference's leaf for leaf
with and without FSDP, and ``model_dims`` names the move; on (1,2) the
placements equal the reference's, the greedy streams of the mixed
requests equal its engine's, a ragged prefill's hidden states and a
decode step's logits sit within its 2e-4 (``torch_mesh_reference``); two
train steps (``tests/test_torch_mesh_train.py``'s warmup-2 schedule and
``_check`` rule) with and without FSDP where the move differs under it,
every leaf the specs replicate over "model" the same bits on both ranks
after each step; and no collective of a decode step over "model" moves as
many bytes as a moved weight leaf of one layer (no weight is gathered).
"""
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ranks as ranks                          # noqa: E402
import torch_mesh_reference as mref                       # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.parallel import sharding as jrules             # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.models import lm as tlm                  # noqa: E402
from repro_torch.parallel import sharding as trules       # noqa: E402
from test_torch_mesh_train import (TC, _check, _jrun,     # noqa: E402
                                   _jtc)

ARCHS = (ranks.VOCAB_TIED, ranks.VOCAB_HEAD, ranks.EXPERTS3, ranks.HEADS3)
MESH = (1, 2)
# the record's moved entries at (1,2), without and with FSDP
MOVES = {
    ranks.VOCAB_TIED: ({"embed": "d_model", "logits": "d_model"},
                       {"embed": None, "logits": None}),
    ranks.VOCAB_HEAD: ({"embed": "d_model", "logits": "d_model"},
                       {"embed": None, "logits": None}),
    ranks.EXPERTS3: ({"moe_in": "d_ff", "moe_out": "d_model"},
                     {"moe_in": "d_ff", "moe_out": "d_ff"}),
    ranks.HEADS3: ({"attn_q": "head_dim", "attn_kv": "head_dim",
                    "attn_out": "d_model"},
                   {"attn_q": "head_dim", "attn_kv": "head_dim",
                    "attn_out": "head_dim"}),
}
# the leaves those moves place ("groups/..." leaves by their tail)
MOVED = {ranks.VOCAB_TIED: ("embed/table",),
         ranks.VOCAB_HEAD: ("embed/table", "lm_head/w"),
         ranks.EXPERTS3: ("moe/wi_gate", "moe/wi_up", "moe/wo"),
         ranks.HEADS3: ("mixer/wq", "mixer/wo")}
MOE_TC = dict(global_batch=2)
# case -> (arch, FSDP forced, TrainerConfig settings over TC)
TRAIN = {
    "minicpm": (ranks.VOCAB_TIED, False, {}),
    "minicpm_fsdp": (ranks.VOCAB_TIED, True, {}),
    "mamba2": (ranks.VOCAB_HEAD, False, {}),
    "mixtral": (ranks.EXPERTS3, False, MOE_TC),
    "mixtral_fsdp": (ranks.EXPERTS3, True, MOE_TC),
    "arctic": (ranks.HEADS3, False, MOE_TC),
    "arctic_fsdp": (ranks.HEADS3, True, MOE_TC),
}
STEPS = 2           # step 1 at lr 0, step 2 moves the parameters


def _ref_key(case):
    arch, _, tc = TRAIN[case]
    return arch, tuple(sorted(tc.items()))


@pytest.fixture(scope="module")
def run():
    """(reference {(arch, "default"): streams, ("numerics", arch): ...,
    ("train", key): (init, steps)}, {rank: {job: result}}, params)."""
    torch.set_num_threads(1)
    refs, params = {}, {}
    for arch in ARCHS:
        jcfg, jp, params[arch] = mref.bridged(arch)
        refs[arch] = jcfg, jp
    # the initial states first (no step compiled), so that the ranks
    # train while the reference's steps compile and run here
    keys = {_ref_key(case): case for case in TRAIN}
    init = {k: _jrun(TRAIN[c][0], dict(TC, **TRAIN[c][2]), 0)[0]
            for k, c in keys.items()}
    jobs = [j for arch in ARCHS for j in mref.model_jobs(arch, MESH)]
    jobs += [dict(name=case, kind="train", mesh=MESH, arch=arch, fsdp=fsdp,
                  tc=dict(TC, **tc), steps=STEPS, init=case)
             for case, (arch, fsdp, tc) in TRAIN.items()]
    shared = dict(params=params, reqs=mref.REQS,
                  train={c: init[_ref_key(c)] for c in TRAIN})
    group = ranks.start(2, jobs, shared)
    ref = {("train", k): _jrun(TRAIN[c][0], dict(TC, **TRAIN[c][2]), STEPS)
           for k, c in keys.items()}
    for arch, (jcfg, jp) in refs.items():
        eng = JEngine(jcfg, jp, **mref.ENGINE)
        ref[arch, "default"] = mref.jserve(eng, mref.REQS["mixed"])
        ref["numerics", arch] = mref.jnumerics(jcfg, jp)
    out = group.results()
    mref.no_errors(out)
    return ref, out, params


def _flat(tree, jax_side):
    if jax_side:
        flat, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        return {jrules.path_str(p): mref._entries(s) for p, s in flat}
    return {trules.path_str(p): mref._entries(s)
            for p, s in ranks._flat(tree)}


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, fsdp):
    """The port's specs of the reduced config on a (1,2) stand-in mesh
    equal the reference's leaf for leaf, and ``model_dims`` reads the move
    they make."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": 2})
    jcfg = mref.jconfig(arch)
    shape = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    want = _flat(jrules.params_specs(jcfg, shape, fsdp, mesh), True)
    cfg = ranks.config(arch)
    got = _flat(trules.params_specs(cfg, tlm.init_lm(None, cfg, "meta"),
                                    fsdp, mesh), False)
    assert got == want
    dims = trules.model_dims(cfg, mesh, fsdp)
    assert {k: dims[k] for k in MOVES[arch][fsdp]} == MOVES[arch][fsdp]
    trules.check_model_axis(cfg, 2, mref.ENGINE["max_len"], 1, fsdp)


# each leaf the record reads: (its dims by name, the record's entries)
RECORD_LEAVES = {
    "embed/table": (("vocab", "d_model"), ("embed",)),
    "lm_head/w": (("d_model", "vocab"), ("logits",)),
    "moe/wi_gate": (("layers", "experts", "d_model", "d_ff"), ("moe_in",)),
    "moe/wi_up": (("layers", "experts", "d_model", "d_ff"), ("moe_in",)),
    "moe/wo": (("layers", "experts", "d_ff", "d_model"), ("moe_out",)),
    "mixer/wq": (("layers", "d_model", "heads", "head_dim"), ("attn_q",)),
    "mixer/wk": (("layers", "d_model", "heads", "head_dim"), ("attn_kv",)),
    "mixer/wv": (("layers", "d_model", "heads", "head_dim"), ("attn_kv",)),
    "mixer/wo": (("layers", "heads", "head_dim", "d_model"), ("attn_out",)),
}
FOLLOWED = {"embed": ("vocab", "d_model", None),
            "logits": ("vocab", "d_model", None),
            "moe_in": ("experts", "d_ff"),
            "moe_out": ("experts", "d_ff", "d_model"),
            "attn_q": ("heads", "head_dim"), "attn_kv": ("heads", "head_dim"),
            "attn_out": ("heads", "head_dim", "d_model")}


def _walked_dims(cfg, specs):
    """The record as every leaf of the whole tree's specs gives it: the
    dim "model" splits on each leaf ``RECORD_LEAVES`` names (attention's
    of the attn / swa layers only), a set per entry."""
    attn = {f"groups/{g}/{i}/"
            for g, (kinds, _) in enumerate(tlm.build_groups(cfg))
            for i, kind in enumerate(kinds) if kind in ("attn", "swa")}
    seen = {}
    for path, spec in ranks._flat(specs):
        ps = trules.path_str(path)
        for tail, (names, keys) in RECORD_LEAVES.items():
            if not ps.endswith(tail) or (tail.startswith("mixer/") and not
                                         any(ps.startswith(a) for a in attn)):
                continue
            dim = next((n for e, n in zip(spec, names)
                        if "model" in trules._names(e)), None)
            keys = keys + (("logits",) if tail == "embed/table"
                           and cfg.tie_embeddings else ())
            for key in keys:
                seen.setdefault(key, set()).add(dim)
    return seen


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_model_dims_is_the_walk_over_every_leaf(arch):
    """``model_dims``, read from the few leaf shapes the config gives,
    equals the record that the whole meta tree's specs give leaf by leaf,
    at full width on every model axis of 2-16, with and without FSDP (a
    data axis of 2 under it)."""
    cfg = tconfigs.get_arch(arch)
    full = tlm.init_lm(None, cfg, device="meta")
    for model in (2, 4, 8, 16):
        for data, fsdp in ((1, False), (2, True)):
            sizes = {"data": data, "model": model}
            mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                         shape=sizes)
            walked = _walked_dims(cfg, trules.params_specs(cfg, full, fsdp,
                                                           mesh))
            dims = trules.model_dims(cfg, sizes, fsdp)
            assert set(dims) == set(walked), (model, fsdp)
            for key, got in walked.items():
                dim = next(iter(got))
                if len(got) == 1 and dim in FOLLOWED[key]:
                    assert dims[key] == dim, (model, fsdp, key)
                else:
                    assert dims[key].startswith("unsupported"), (model, key)


@pytest.mark.parametrize("check", ["placements", "streams", "numerics"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moved_axis_serves_as_the_reference(run, arch, check):
    mref.check_model(run, arch, MESH, check)


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_moved_axis_trains_as_the_reference(run, case):
    ref, out, _ = run
    got = {r: out[r][case] for r in out}
    assert all(g["fsdp"] is TRAIN[case][1] for g in got.values())
    _check(got, ref["train", _ref_key(case)][1], _jtc(TRAIN[case][2]))


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_each_rank_holds_the_moved_shards(run, case):
    """Every leaf's local shape is the one its spec gives; each moved
    leaf the model axis splits is half its whole, and a leaf the move
    replicates is whole."""
    _, out, _ = run
    arch, fsdp, _ = TRAIN[case]
    dims = trules.model_dims(ranks.config(arch),
                             {"data": 1, "model": 2}, fsdp)
    for r in out:
        shapes = out[r][case]["shapes"]
        bad = [(p, a, b) for p, a, b, _ in shapes if a != b]
        assert not bad, (r, bad[:3])
        moved = [(p, a, w) for p, a, _, w in shapes if p.startswith(
            "params/") and p.endswith(MOVED[arch])]
        assert moved
        for p, a, w in moved:
            split = (dims["embed"] if p.endswith("embed/table") else
                     dims.get("logits") if p.endswith("lm_head/w") else 1)
            halves = int(np.prod(w)) // int(np.prod(a))
            assert halves == (1 if split is None else 2), (p, a, w)


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_replicated_leaves_equal_across_model_ranks(run, case):
    """The minicpm FSDP case's table (replicated over "model") and every
    other replicated leaf: the same bits on both ranks after each step
    (a gradient summed over "model" where the forward is the same on
    every rank would double it on each)."""
    _, out, _ = run
    reps = [out[r][case]["replicas"] for r in sorted(out)]
    assert len(reps[0]) == STEPS
    for step, first in enumerate(reps[0]):
        assert first, "no replicated leaf"
        bad = [p for p in first if reps[1][step][p] != first[p]]
        assert not bad, (step, bad[:5])
    if case == "minicpm_fsdp":
        assert "params/embed/table" in reps[0][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_gathers_no_weight(run, arch):
    """Every collective of a decode step over "model" moves fewer bytes
    than one layer's slice of any leaf the move placed: activations
    cross the axis, never a weight."""
    _, out, params = run
    leaves = {trules.path_str(p): a for p, a in ranks._flat(params[arch])}
    smallest = min(a.nbytes // (a.shape[0] if p.startswith("groups/")
                                else 1)
                   for p, a in leaves.items() if p.endswith(MOVED[arch]))
    for r in out:
        sizes = out[r][f"{arch}/logits_1x2"]["decode_gathers"]
        assert sizes and {a for a, _ in sizes} == {"model"}
        assert max(n for _, n in sizes) < smallest, (r, sorted(sizes)[-3:])
