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
"""
import jax
import numpy as np

import torch_mesh_ranks as ranks
from repro import configs as jconfigs
from repro.models import lm as jlm
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


def bridged(arch):
    """(reference config, reference params, the port's tree as numpy)."""
    jcfg = jconfigs.get_arch(arch).reduced()
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


def run(archs):
    """The ranks serve every (arch, path) on the (2,1) mesh while the
    reference serves the paths of ``SERVED_BY`` here.  Returns (reference
    {(arch, path): (streams, metrics)}, ranks' results)."""
    ref, params, jps = {}, {}, {}
    for arch in archs:
        jcfg, jp, params[arch] = bridged(arch)
        jps[arch] = jcfg, jp
    jobs = [dict(name=f"{arch}/{path}", kind="serve", mesh=(2, 1),
                 arch=arch, engine={**ENGINE, **kw}, reqs="mixed",
                 script=script)
            for arch in archs for path, (kw, script) in PATHS.items()]
    group = ranks.start(2, jobs, dict(params=params, reqs=REQS))
    for arch, (jcfg, jp) in jps.items():
        for path in sorted(set(SERVED_BY.values())):
            eng = JEngine(jcfg, jp, **ENGINE, **PATHS[path][0])
            ref[arch, path] = jserve(eng, REQS["mixed"])
    out = group.results()
    no_errors(out)
    return ref, out


def check(run, arch, path):
    ref, out = run
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
