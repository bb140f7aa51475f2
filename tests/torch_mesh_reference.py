"""The reference side of the port's mesh tests on the CPU
(``tests/test_torch_mesh_*.py``): the reduced configs' parameters drawn by
the reference and bridged (``bridged``), its one-device engine serving a
request list (``jserve``), and for the other kinds' data axis
(``run``, ``check``): per arch, the reference serves one request list
down every serving path while two spawned ranks
(``tests/torch_mesh_ranks.py``) serve it on the port's (2,1) mesh.

The data axis changes no model code, so every stream (and the speculative
acceptance) is bitwise the reference's; the paged paths' streams are the
uninterrupted ones.

The model axis splits reductions, so it is held as the reference holds
its own (``tests/test_serving_mesh.py:370-410``): ``model_jobs`` /
``check_model`` serve the mixed requests on a model-axis mesh (placements
equal the reference's ``fit_spec``-ted rules, the greedy requests' streams
equal the reference's), and run a ragged two-chunk prefill and a decode
step whose hidden states and logits stay within ``TOL`` of the live
reference's (``jnumerics``, ``check_numerics``).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np

import torch_mesh_ranks as ranks
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.parallel import sharding as jrules
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.bridge import to_numpy, to_torch


def requests(n, stochastic, max_new=6, step=3, grow=1):
    """Request settings: prompts of 6 + step * i tokens, budgets of
    max_new + grow * i; request 0 (the one the paging scripts pause)
    draws when ``stochastic``, as every even one does."""
    return [dict(rid=i, prompt=np.arange(1, 7 + step * i, dtype=np.int32),
                 max_new_tokens=max_new + grow * i,
                 temperature=0.8 if stochastic and i % 2 == 0 else 0.0,
                 top_k=10 if stochastic and i % 2 == 0 else 0,
                 top_p=0.9 if stochastic and i % 2 == 0 else 1.0)
            for i in range(n)]


ENGINE = dict(max_slots=4, max_len=64, decode_block=2, prefill_chunk=8)
# path -> (engine settings, paging script)
PATHS = {
    "default": ({}, None),
    "pow2": (dict(plan_mode="pow2"), None),
    "spec": (dict(speculative=True, k_draft=2), None),
    "pause": ({}, "sync"),
    "async": (dict(async_paging=True), "async"),
}
# long enough to roll recurrentgemma's 32-token window
REQS = {"mixed": requests(4, True, max_new=5, step=9, grow=2)}
# the reference engine that serves each path (the paged paths' streams
# are its uninterrupted ones)
SERVED_BY = {"default": "default", "pow2": "pow2", "spec": "spec",
             "pause": "default", "async": "default"}


TOL = 2e-4          # the reference's own check of its model axis


def jconfig(arch):
    """The reference's reduced config of ``arch`` or of a name of
    ``ranks.VARIANTS`` (as ``ranks.config``)."""
    base, kw = ranks.VARIANTS.get(arch, (arch, {}))
    return jconfigs.get_arch(base).reduced().replace(**kw)


def bridged(arch):
    """(reference config, reference params, the port's tree as numpy)."""
    jcfg = jconfig(arch)
    jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, to_numpy(to_torch(jax.tree.map(np.asarray, jp)))


def jserve(eng, specs, script=None):
    """The reference engine serves ``specs`` (through the paging script
    ``script``, "sync" or "async"); returns (streams, metrics)."""
    reqs = [JRequest(**r) for r in specs]
    if script is None:
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
    else:
        ranks._paused_run(eng, reqs, async_paging=script == "async")
    m = eng.metrics()
    eng.reset_metrics()
    return [list(r.output) for r in reqs], m


def no_errors(out):
    for r, res in out.items():
        for name, v in res.items():
            assert "error" not in v, f"rank {r}, {name}:\n{v['error']}"


def run(archs, model_archs=(), extra_jobs=(), world=2):
    """The ranks serve every (arch, path) of ``archs`` on the (2,1) mesh
    and ``model_jobs`` of ``model_archs`` on (1,2), then ``extra_jobs``,
    while the reference serves the paths of ``SERVED_BY`` here (only the
    default one for ``model_archs`` alone) and computes the model-axis
    numerics.  Returns (reference {(arch, path): (streams, metrics),
    ("numerics", arch): ...}, ranks' results, the bridged params)."""
    ref, params, jps = {}, {}, {}
    for arch in dict.fromkeys(archs + tuple(model_archs)):
        jcfg, jp, params[arch] = bridged(arch)
        jps[arch] = jcfg, jp
    jobs = [dict(name=f"{arch}/{path}", kind="serve", mesh=(2, 1),
                 arch=arch, engine={**ENGINE, **kw}, reqs="mixed",
                 script=script)
            for arch in archs for path, (kw, script) in PATHS.items()]
    jobs += [j for arch in model_archs for j in model_jobs(arch, (1, 2))]
    group = ranks.start(world, jobs + list(extra_jobs),
                        dict(params=params, reqs=REQS))
    for arch, (jcfg, jp) in jps.items():
        paths = set(SERVED_BY.values()) if arch in archs else {"default"}
        for path in sorted(paths):
            eng = JEngine(jcfg, jp, **ENGINE, **PATHS[path][0])
            ref[arch, path] = jserve(eng, REQS["mixed"])
        if arch in model_archs:
            ref["numerics", arch] = jnumerics(jcfg, jp)
    out = group.results()
    no_errors(out)
    return ref, out, params


# ------------------------------------------------------------ model axis

# a ragged two-chunk prefill from zeroed caches, then one decode step, of
# four rows: 32 + 3 to 16 tokens roll the reduced 32-token windows (and
# fill whole groups of the reduced MoE)
NUMERICS_VALID = np.array([16, 9, 13, 3], np.int32)


def numerics_inputs():
    rng = np.random.default_rng(0)
    return dict(chunk1=rng.integers(1, 256, (4, 32)),
                chunk2=rng.integers(1, 256, (4, 16)),
                valid=NUMERICS_VALID,
                tok=rng.integers(1, 256, (4,)).astype(np.int32))


def model_jobs(arch, mesh, reqs="mixed"):
    """The mixed requests (``REQS["mixed"]``, under the key ``reqs`` of
    the ranks' shared requests) served on ``mesh`` (a model-axis layout)
    and the numerics' prefill and decode step there."""
    tag = f"{mesh[0]}x{mesh[1]}"
    return [dict(name=f"{arch}/tp_{tag}", kind="serve", mesh=mesh,
                 arch=arch, engine=ENGINE, reqs=reqs),
            dict(name=f"{arch}/logits_{tag}", kind="logits", mesh=mesh,
                 arch=arch, batch=4, max_len=ENGINE["max_len"],
                 inputs=numerics_inputs())]


def jnumerics(jcfg, jp):
    """The live reference's hidden states and logits of the numerics."""
    x = numerics_inputs()
    c = jlm.init_caches(jcfg, 4, ENGINE["max_len"])
    h1, c = jlm.prefill_chunk(jp, jcfg, c, tokens=jnp.asarray(x["chunk1"]))
    h2, c = jlm.prefill_chunk(jp, jcfg, c, tokens=jnp.asarray(x["chunk2"]),
                              valid_len=jnp.asarray(x["valid"]))
    logits, _ = jlm.decode_step(jp, jcfg, jnp.asarray(x["tok"]), c)
    return dict(h1=np.asarray(h1), h2=np.asarray(h2),
                logits=np.asarray(logits))


def check_numerics(want, outs, name):
    """Each rank's rows (``outs``: the ranks' results of job ``name``)
    within ``TOL`` of the reference's; a row's hidden states past its
    valid length are garbage on both sides."""
    for r, res in enumerate(outs):
        got = res[name]
        rows = slice(*got["rows"])
        for key in ("h1", "h2", "logits"):
            w = want[key][rows]
            if key == "h2":
                c = w.shape[1]
                keep = np.arange(c)[None, :, None] < \
                    NUMERICS_VALID[rows, None, None]
                w = np.where(keep, w, got[key])
            np.testing.assert_allclose(got[key], w, rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} {name} {key}")
        assert got["collectives"] > 0


def _entries(spec):
    """A spec as comparable entries (jax writes a one-axis tuple entry as
    the axis name, so both sides do), trailing Nones dropped."""
    out = [e[0] if isinstance(e, (list, tuple)) and len(e) == 1
           else (tuple(e) if isinstance(e, (list, tuple)) else e)
           for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def jplacements(arch, mesh):
    """The reference's rules on ``mesh`` (data, model) for the engine's
    parameters and slot caches: {path: entries} each."""
    jcfg = jconfig(arch)
    m = types.SimpleNamespace(axis_names=("data", "model"),
                              shape=dict(data=mesh[0], model=mesh[1]))

    def flat(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        return {jrules.path_str(p): _entries(s) for p, s in leaves}
    shape = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    slots = ENGINE["max_slots"]
    cache = jax.eval_shape(
        lambda: jlm.init_caches(jcfg, slots, ENGINE["max_len"]))
    return (flat(jrules.params_specs(jcfg, shape, False, m)),
            flat(jrules.slot_specs(jcfg, m, cache, slots)))


def check_placements(got, arch, mesh):
    """A serve job's parameter and slot-cache placements equal the
    reference's rules, and each local block is the full leaf split by
    them."""
    jparams, jcaches = jplacements(arch, mesh)
    params = {p: _entries(s) for p, s in got["param_placements"].items()}
    assert params == jparams
    caches = dict(zip(got["cache_paths"],
                      (_entries(s) for s in got["placements"]["caches"])))
    assert caches == jcaches
    sizes = {"data": mesh[0], "model": mesh[1], None: 1}
    for spec, full, local in zip(got["placements"]["caches"],
                                 got["shapes"]["full_caches"],
                                 got["shapes"]["caches"]):
        spec = list(spec) + [None] * (len(full) - len(spec))
        assert local == tuple(
            n // np.prod([sizes[a] for a in (e if isinstance(e, tuple)
                                             else (e,))])
            for n, e in zip(full, spec))


def check_model(run, arch, mesh=(1, 2), check="streams"):
    """One check of ``arch`` on a model-axis ``mesh``: "streams" (every
    rank's greedy requests equal the reference's, the ranks' plans
    equal), "numerics" or "placements"."""
    ref, out, _ = run
    tag = f"{mesh[0]}x{mesh[1]}"
    n = mesh[0] * mesh[1]
    if check == "numerics":
        return check_numerics(ref["numerics", arch],
                              [out[r] for r in range(n)],
                              f"{arch}/logits_{tag}")
    got = [out[r][f"{arch}/tp_{tag}"] for r in range(n)]
    m = got[0]["metrics"]
    assert (m["mesh_data"], m["mesh_model"]) == mesh
    if check == "placements":
        return check_placements(got[0], arch, mesh)
    want = ref[arch, "default"][0]
    greedy = [i for i, r in enumerate(REQS["mixed"])
              if r["temperature"] == 0.0]
    for g in got:
        assert g["done"]
        assert [g["streams"][i] for i in greedy] == \
            [want[i] for i in greedy]
    assert len({g["plan"] for g in got}) == 1


def check(run, arch, path):
    ref, out, _ = run
    want, jm = ref[arch, SERVED_BY[path]]
    got = [out[r][f"{arch}/{path}"] for r in range(2)]
    assert got[0]["done"] and got[0]["streams"] == want
    assert got[1]["streams"] == want
    assert got[0]["plan"] == got[1]["plan"]
    m = got[0]["metrics"]
    assert (m["mesh_data"], m["mesh_model"]) == (2, 1)
    if path == SERVED_BY[path]:
        assert m["stage_dispatches"] == jm["stage_dispatches"]
        assert m["scatter_dispatches"] == jm["scatter_dispatches"]
    if path == "spec":
        assert m["accepted_tokens"] == jm["accepted_tokens"] > 0
    if path in ("pause", "async"):
        assert m["swap_outs"] >= 1 and m["swap_ins"] >= 1
        assert m["swap_bytes"] == (m["swap_outs"] + m["swap_ins"]) * \
            m["swap_bytes_per_slot"]
    if path == "async":
        assert m["swap_prefetch_hits"] >= 1
