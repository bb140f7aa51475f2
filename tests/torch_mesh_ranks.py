"""Mesh ranks for the port's sharded-serving and training tests on the
CPU (``tests/test_torch_mesh_*.py``).

``start(world, jobs, shared)`` spawns ``world`` processes in one gloo group
(``tcp://localhost``), each running every job whose mesh holds it;
``results()`` of what it returns waits for each rank's results (so the
caller can run the reference meanwhile).  This module imports torch and
the port only, so a rank never starts jax.  A job is a dict: ``kind``
(the function of ``JOBS`` that runs it), ``mesh`` (data, model) over the
first ranks, and the job's own settings; ``shared`` holds what several
jobs read (parameter trees as numpy by arch, request lists, images).
Every serve job records the executor calls its engine made
(``_Recorder``), so the tests can check that the ranks of a mesh agreed
on every tick's plan.
"""
from __future__ import annotations

import hashlib
import os
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs
from repro_torch.bridge import to_torch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.parallel import comm
from repro_torch.parallel import sharding as rules
from repro_torch.serving.engine import DecodeEngine, Request
from repro_torch.tree import leaves, tree_map_with_path

# the executor calls that carry a tick's plan
PLAN_CALLS = ("decode", "stage_begin", "stage_chunk_scan", "stage_chunk",
              "stage_admit", "scatter", "bstage_begin", "bstage_chunk_scan",
              "bstage_admit", "bscatter", "gather_slot_async",
              "gather_staging_async", "bgather_row_async", "restore_slot",
              "spec_draft", "spec_verify", "draft_prefill_slot",
              "release_slot")


class start:
    """Spawn ``world`` gloo ranks over ``jobs``; ``results()`` returns
    {rank: {job name: result}} (a failed job's result is {"error":
    traceback})."""

    def __init__(self, world: int, jobs, shared):
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue()
        # ``shared`` goes through a queue, not the spawn arguments: those
        # are written to each child before ``start`` returns, which would
        # wait for every rank's imports in turn
        self.inbox = ctx.Queue()
        port = mesh_mod.free_port()
        self.procs = [ctx.Process(target=_rank, args=(
            r, world, port, jobs, self.inbox, self.q))
            for r in range(world)]
        for p in self.procs:
            p.start()
            self.inbox.put(shared)

    def results(self, timeout: float = 600.0):
        try:
            return dict(self.q.get(timeout=timeout) for _ in self.procs)
        finally:
            for p in self.procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()


def _rank(rank, world, port, jobs, inbox, q):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    shared = inbox.get()
    mesh_mod.init_ranks(rank, world, port, "gloo")
    out = {}
    try:
        meshes = {}
        for job in jobs:
            shape = tuple(job["mesh"])
            if shape not in meshes:
                # every rank builds every mesh (its groups are collective)
                meshes[shape] = mesh_mod.make_serving_mesh(*shape)
            mesh = meshes[shape]
            if mesh.get_coordinate() is None:
                continue
            try:
                t0 = time.perf_counter()
                out[job["name"]] = JOBS[job["kind"]](job, shared, mesh)
                out[job["name"]]["seconds"] = time.perf_counter() - t0
            except Exception:
                out[job["name"]] = {"error": traceback.format_exc()}
        dist.barrier()          # no rank tears down mid-collective
    finally:
        q.put((rank, out))
        dist.destroy_process_group()


# ------------------------------------------------------------- helpers

# a reduced config that is no arch of the registry: qwen3-next-gdn's with
# the Alg. 1 GDN decode
NAIVE = "gdn_naive"


# qwen3-next-gdn's reduced config with one KV head: a model axis of 2
# splits its KV projections on head_dim (``fit_spec``)
MQA = "qwen3-next-gdn-kv1"
# qwen3-next-gdn's reduced config with every gdn layer a gdn_naive one
NAIVE_ALL = "qwen3-next-gdn-naive"
# mamba2-1.3b's reduced config with a d_state (33) that no model axis of
# 2 divides
SSM_ODD = "mamba2-1.3b-dstate33"

# qwen3-next-gdn's reduced config in bf16 activations (and parameters)
BF16 = "qwen3-next-gdn-bf16"

# the reduced configs that are no arch of the registry: name -> (arch,
# ``replace`` settings), the same on the reference's side
VARIANTS = {
    NAIVE: ("qwen3-next-gdn", dict(pattern=("gdn_naive", "attn"))),
    MQA: ("qwen3-next-gdn", dict(n_kv_heads=1)),
    NAIVE_ALL: ("qwen3-next-gdn", dict(
        pattern=("gdn_naive", "gdn_naive", "gdn_naive", "attn"))),
    SSM_ODD: ("mamba2-1.3b", dict(ssm_d_state=33)),
    BF16: ("qwen3-next-gdn", dict(act_dtype="bfloat16")),
}


def config(arch):
    """The reduced config of ``arch`` or of a name of ``VARIANTS``."""
    base, kw = VARIANTS.get(arch, (arch, {}))
    return configs.get_arch(base).reduced().replace(**kw)


def model(shared, arch):
    """(cfg, params on the CPU) of ``arch``: the reduced config, with the
    bridged reference parameters of ``shared["params"]``."""
    return config(arch), to_torch(shared["params"][arch])


def requests(specs):
    return [Request(**dict(s)) for s in specs]


class _Recorder:
    """Logs every plan call of an executor (name and arguments) into a
    digest, so two ranks' plans compare as two strings."""

    def __init__(self, ex):
        self.h = hashlib.sha256()
        self.calls = 0
        for name in PLAN_CALLS:
            real = getattr(ex, name)
            setattr(ex, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def call(*args, **kwargs):
            self.calls += 1
            self.h.update(name.encode())
            for a in list(args) + sorted(kwargs.items()):
                self.h.update(_digest(a))
            return real(*args, **kwargs)
        return call

    def digest(self):
        return self.h.hexdigest()


def _digest(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return repr((a.dtype, tuple(a.shape))).encode()
    if isinstance(a, np.ndarray):
        return a.tobytes()
    if isinstance(a, (list, tuple)):
        return b"(" + b",".join(_digest(x) for x in a) + b")"
    if hasattr(a, "caches"):                 # a SwappedState
        return b"".join(np.asarray(x).tobytes() for x in leaves(a.caches))
    return repr(a).encode()


def engine(cfg, params, mesh, kw):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng = DecodeEngine(cfg, params, device="cpu", mesh=mesh, **kw)
    return eng, [str(x.message) for x in w]


def _step_until(eng, pred, max_ticks=100):
    for _ in range(max_ticks):
        eng.step()
        if pred():
            return
    raise AssertionError("condition not reached")


def _paused_run(eng, reqs, async_paging):
    """The paging script: pause request 0 mid-decode, step, resume; on
    an async engine harvest, prefetch ahead of the grant and consume it
    (a prefetch hit)."""
    for r in reqs:
        eng.submit(r)
    _step_until(eng, lambda: reqs[0].state == "active"
                and len(reqs[0].output) >= 2)
    eng.pause(0)
    eng.step()
    eng.resume(0)
    if async_paging:
        eng.flush_swaps()
        eng._prefetch_resume()
        assert eng.swapped[0].prefetch is not None, "prefetch did not stage"
    eng.run_until_done()


# ---------------------------------------------------------------- jobs

def serve_job(job, shared, mesh):
    """Serve ``job["reqs"]`` (optionally through the paging script) and
    report the streams, the metrics the tests read, the warnings, the
    plan digest and the buffers' placements and local shapes."""
    cfg, params = model(shared, job["arch"])
    eng, warns = engine(cfg, params, mesh, job["engine"])
    rec = _Recorder(eng.executor)
    reqs = requests(shared["reqs"][job["reqs"]])
    script = job.get("script")
    guard = None
    if job.get("guard"):
        # the host guard over every program call after its first
        import pytest
        from torch_host_guard import guard_programs
        patch = pytest.MonkeyPatch()
        guard = guard_programs(patch)
    try:
        if script is None:
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
        else:
            _paused_run(eng, reqs, async_paging=script == "async")
    finally:
        if guard is not None:
            patch.undo()
    m = eng.metrics()
    ex = eng.executor

    def shapes(tree):
        return [tuple(t.shape) for t in leaves(tree)]

    def spec_list(tree):
        return [tuple(s) for s in leaves(tree)]

    out = {
        "streams": [list(r.output) for r in reqs],
        "done": all(r.done for r in reqs),
        "metrics": {k: m[k] for k in (
            "mesh_data", "mesh_model", "accepted_tokens", "drafted_tokens",
            "swap_outs", "swap_ins", "swap_bytes", "swap_bytes_per_slot",
            "swap_prefetch_hits", "swap_prefetches", "stage_dispatches",
            "scatter_dispatches", "prefill_batching")},
        "warnings": warns,
        "plan": rec.digest(), "plan_calls": rec.calls,
        "guarded": None if guard is None else guard["guarded"],
        "placements": {k: ({n: tuple(s) for n, s in v.items()}
                           if k == "sampler" else spec_list(v))
                       for k, v in ex.placements.items()
                       if k not in ("params", "draft_params")},
        "param_placements": {
            rules.path_str(p): tuple(s) for p, s in _flat(
                ex.placements.get("params"))},
        "shapes": {"caches": shapes(ex.caches),
                   "tokens": tuple(ex.tokens.shape),
                   "sampler": {k: tuple(v.shape)
                               for k, v in ex.sampler.items()},
                   "full_caches": [s.shape for s in ex.spec.leaves()]},
        "cache_paths": [rules.path_str(p) for p, _ in _flat(ex.caches)],
    }
    if ex.speculative:
        out["shapes"]["ckpt"] = shapes(ex.ckpt)
        out["shapes"]["dcaches"] = shapes(ex.dcaches)
    if getattr(ex, "_batched_ready", False):
        out["shapes"]["bstaging"] = shapes(ex.bstaging)
    return out


def _flat(tree):
    """[(key path, leaf)] of a port tree (NamedTuple fields by name)."""
    out = []

    def put(path, x):
        out.append((path, x))
    tree_map_with_path(put, tree)
    return out


def logits_job(job, shared, mesh):
    """The reference's own check of the model axis on the port: a
    ragged two-chunk prefill and one decode step on this rank's shards of
    the bridged parameters and of zeroed caches (slots on "data"),
    returning this rank's rows of the hidden states and the logits."""
    cfg, params = model(shared, job["arch"])
    axes = comm.MeshAxes(mesh)
    B, L = job["batch"], job["max_len"]
    spec = lm.cache_specs(cfg, B, L)
    parts = rules.slot_specs(cfg, mesh, spec.tree, B)
    caches = rules.map_specs(
        lambda s, p: torch.zeros(rules.local_shape(s.shape, p, axes.sizes),
                                 dtype=s.dtype), spec.tree, parts)
    local = rules.shard_tree(params, rules.params_specs(cfg, params, False,
                                                        mesh),
                             axes.coords, axes.sizes)
    b = B // axes.data.size
    rows = slice(axes.data.index * b, (axes.data.index + 1) * b)
    x = {k: torch.from_numpy(np.asarray(v)[rows]) for k, v in
         job["inputs"].items()}
    comm.reset_stats()
    with comm.use(axes):
        h1, _ = lm.prefill_chunk(local, cfg, caches, tokens=x["chunk1"])
        h2, _ = lm.prefill_chunk(local, cfg, caches, tokens=x["chunk2"],
                                 valid_len=x["valid"])
        logits, _ = lm.decode_step(local, cfg, x["tok"], caches)
    return {"rows": (rows.start, rows.stop), "h1": h1.numpy(),
            "h2": h2.numpy(), "logits": logits.numpy(),
            "collectives": comm.stats["calls"]}


def swap_job(job, shared, mesh):
    """Pause request 0 mid-decode on this mesh, keep its host image and
    the stream it goes on to emit after the resume."""
    cfg, params = model(shared, job["arch"])
    eng, _ = engine(cfg, params, mesh, job["engine"])
    reqs = requests(shared["reqs"][job["reqs"]])
    for r in reqs:
        eng.submit(r)
    _step_until(eng, lambda: reqs[0].state == "active"
                and len(reqs[0].output) >= 2)
    eng.pause(0)
    sw = eng.swapped[0].state
    n = len(reqs[0].output)
    eng.resume(0)
    eng.run_until_done()
    return {"image": sw, "n": n, "after": list(reqs[0].output[n:]),
            "streams": [list(r.output) for r in reqs],
            "swap_bytes_per_slot": eng.executor.swap_bytes_per_slot}


def restore_job(job, shared, mesh):
    """Restore a host image (``shared["images"][job["image"]]``) into slot
    ``job["slot"]`` of this mesh's engine and decode it to its end."""
    cfg, params = model(shared, job["arch"])
    eng, _ = engine(cfg, params, mesh, job["engine"])
    ex = eng.executor
    slot = job["slot"]
    ex.restore_slot(slot, shared["images"][job["image"]])
    got = []
    for _ in range(64):
        toks, valid = ex.decode(2)
        got += [int(t) for t, v in zip(toks[:, slot], valid[:, slot]) if v]
        assert not np.delete(valid, slot, axis=1).any()  # the rest inert
        if not valid[-1, slot]:
            break
    return {"got": got}


def draw_job(job, shared, mesh):
    """``lm.init_lm(seed, cfg, mesh=)`` on this rank (its shards alone,
    the experts drawn one at a time) against the cut of the one-device
    draw, leaf for leaf; then an engine takes the drawn shards as they
    are and one decode tick runs."""
    cfg = config(job["arch"])
    axes = comm.MeshAxes(mesh)
    local = lm.init_lm(0, cfg, device="cpu", mesh=mesh)
    full = lm.init_lm(0, cfg, device="cpu")
    cut = rules.shard_tree(full, rules.params_specs(cfg, full, False, mesh),
                           axes.coords, axes.sizes)
    pairs = list(zip(leaves(local), leaves(cut)))
    eng, _ = engine(cfg, local, mesh, job["engine"])
    eng.submit(Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32),
                       max_new_tokens=3))
    eng.run_until_done()
    return {"leaves": len(pairs),
            "equal": all(a.shape == b.shape and torch.equal(a, b)
                         for a, b in pairs),
            "expert_rows": tuple(local["groups"][0][0]["moe"]["wo"].shape),
            "tokens": eng.metrics()["tokens"]}


def step_job(job, shared, mesh):
    """One decode step of a full-width config cut to ``job["layers"]``
    layers on ``job["device"]`` (card 0 when "cuda"): this rank's shards
    of the weights drawn alone from seed 0 (``lm.init_lm(..., mesh=)``),
    of the full caches ``shared["state"]`` (host numpy, a one-device
    prefill's, bf16 leaves as fp32) and the step's tokens; returns this
    rank's logits."""
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(0)
    cfg = configs.get_arch(job["arch"]).replace(n_layers=job["layers"])
    axes = comm.MeshAxes(mesh)
    params = lm.init_lm(0, cfg, device=device, mesh=mesh)
    caches, tok = shared["state"]
    B = tok.shape[0]
    spec = lm.cache_specs(cfg, B, job["max_len"]).tree
    parts = rules.slot_specs(cfg, mesh, spec, B)
    local = rules.shard_tree(
        rules.map_specs(lambda a, s: torch.from_numpy(a).to(s.dtype),
                        caches, spec), parts, axes.coords, axes.sizes)
    local = rules.map_specs(lambda t, _: t.to(device), local, parts)
    with comm.use(axes):
        logits, _ = lm.decode_step(params, cfg, torch.from_numpy(tok).to(
            device), local)
    return {"logits": logits.float().cpu().numpy()}


def train_job(job, shared, mesh):
    """Train the reduced ``job["arch"]`` on this mesh from the bridged
    reference state ``shared["train"][job["init"]]`` (host numpy, the
    port's tree), cut into this rank's shards: ``job["steps"]`` steps of
    ``Trainer.step`` on the loader's batches from ``job["start"]`` (0),
    ``job["tc"]`` the TrainerConfig's settings (``adamw``: AdamWConfig
    settings), ``job["fsdp"]`` forcing FSDP (``sharding.needs_fsdp``
    patched for the job), ``job["save"]`` a checkpoint directory written
    after step ``job["save_at"]`` (default: the last) and
    ``job["restore"]`` one to resume from instead of the shared state
    (``job["init"]`` None: the trainer's own draw from its seed).
    Returns the per-step metrics, the whole final state
    (rank 0, gathered leaf by leaf), the local leaf shapes beside the
    shapes the specs give, ``fsdp``, the rank's mesh coordinates and,
    after each step, a digest of every state leaf the specs replicate
    over "model" (``replicas``)."""
    from repro_torch.optim.optimizers import AdamWConfig
    from repro_torch.runtime import trainer as tmod
    cfg = config(job["arch"])
    kw = dict(job.get("tc", {}))
    if "adamw" in kw:
        kw["adamw"] = AdamWConfig(**kw["adamw"])
    tc = tmod.TrainerConfig(**kw)
    patch = None
    if job.get("fsdp"):
        import pytest
        patch = pytest.MonkeyPatch()
        patch.setattr(rules, "needs_fsdp", lambda *a, **k: True)
    try:
        tr = tmod.Trainer(cfg, tc, mesh=mesh, device="cpu").compile()
        if job.get("restore"):
            tr.ckpt = tmod.ckpt.CheckpointManager(job["restore"])
            start = tr._maybe_restore()
        else:
            start = job.get("start", 0)
            if job["init"] is not None:
                src = to_torch(shared["train"][job["init"]])
                tmod.ckpt.copy_into(tr.state, rules.shard_tree(
                    src, tr.specs, tr.axes.coords, tr.axes.sizes))
        metrics, replicas = [], []
        end = start + job["steps"]
        for step in range(start, end):
            tr.batch(step)
            m = tr.step()
            metrics.append({k: float(v) for k, v in m.items()})
            replicas.append(_replica_digests(tr))
            if job.get("save") and step + 1 == job.get("save_at", end):
                tr.ckpt = tmod.ckpt.CheckpointManager(job["save"])
                tr.save(step + 1)
        axes = tr.axes
        whole = rules.map_specs(
            lambda t, s: _host(rules.gather_shard(t.detach(), s, axes.axes)),
            tr.state, tr.specs)
        shapes = _local_shapes(tr)
    finally:
        if patch is not None:
            patch.undo()
    first = all(i == 0 for i in axes.coords.values())
    return {"metrics": metrics, "fsdp": tr.fsdp, "shapes": shapes,
            "state": whole if first else None, "start": start,
            "coords": dict(axes.coords), "replicas": replicas}


def _host(t):
    """A tensor as numpy (bf16 widened to fp32, exactly)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _replica_digests(tr):
    """{key path: sha256 of the local bytes} of every state leaf whose
    spec places no dim on "model" (the ranks of a model axis must hold
    the same bits of each)."""
    specs = dict(_flat(tr.specs))
    out = {}
    for path, t in _flat(tr.state):
        if any("model" in names for names in rules.dim_axes(specs[path],
                                                             t.dim())):
            continue
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
        out[rules.path_str(path)] = hashlib.sha256(
            raw.numpy().tobytes()).hexdigest()
    return out


def _local_shapes(tr):
    """[(key path, the leaf's local shape, the specs' local shape, the
    whole shape)] of a trainer's state."""
    out = []
    full = dict(_flat(tr._full))
    specs = dict(_flat(tr.specs))
    for path, t in _flat(tr.state):
        whole = tuple(full[path].shape)
        out.append((rules.path_str(path), tuple(t.shape), rules.local_shape(
            whole, specs[path], tr.axes.sizes), whole))
    return out


def mean_flat_job(job, shared, mesh):
    """``Axis.mean_flat`` over "data" against ``all_reduce(mean=True)``
    and then the rank's block: per tensor (fp32 and bf16, whole, split on
    one dim or on two) whether the two are equal bit for bit."""
    axis = comm.MeshAxes(mesh).data
    g = torch.Generator().manual_seed(1 + axis.index)
    cases = [((8, 6), (0,), torch.float32),
             ((4, 3, 8), (0, 2), torch.bfloat16),
             ((5,), (), torch.float32), ((12, 2), (0,), torch.bfloat16),
             ((3,), (), torch.bfloat16)]
    ts = [torch.randn(s, generator=g).to(dt) for s, _, dt in cases]
    split = [d for _, d, _ in cases]
    got = axis.mean_flat(ts, split)
    equal = []
    for t, dims, a in zip(ts, split, got):
        w = axis.all_reduce(t, mean=True)
        for d in dims:
            w = axis.local(w, d)
        equal.append(a.shape == w.shape and bool(torch.equal(a, w)))
    return {"equal": equal}


def mean_over_job(job, shared, mesh):
    """``comm.mean_over`` over "model" against the serving form
    ``all_reduce(x) / size`` (fp32, each rank its own values): whether the
    two are equal bit for bit, outside autograd and with a gradient
    tracked; and the gradient of the tracked form (the mean of the
    ranks' gradients), returned for the test to check."""
    axis = comm.MeshAxes(mesh).model
    g = torch.Generator().manual_seed(7 + axis.index)
    x = torch.randn((3, 5), generator=g)
    want = axis.all_reduce(x) / axis.size
    plain = comm.mean_over(axis, x)
    xt = x.clone().requires_grad_(True)
    tracked = comm.mean_over(axis, xt)
    w = torch.randn((3, 5), generator=g)
    (tracked * w).sum().backward()
    return {"plain": bool(torch.equal(plain, want)),
            "tracked": bool(torch.equal(tracked.detach(), want)),
            "w": w.numpy(), "grad": xt.grad.numpy(), "index": axis.index}


def refuse_job(job, shared, mesh):
    """The trainer's refusal of ``job["arch"]`` on this mesh: the
    exception's type and message."""
    from repro_torch.runtime import trainer as tmod
    try:
        tmod.Trainer(config(job["arch"]), tmod.TrainerConfig(), mesh=mesh,
                     device="cpu")
    except Exception as e:          # noqa: BLE001 — reported to the test
        return {"type": type(e).__name__, "message": str(e)}
    return {"type": None, "message": ""}


JOBS = {"serve": serve_job, "logits": logits_job, "swap": swap_job,
        "restore": restore_job, "draw": draw_job, "step": step_job,
        "train": train_job, "refuse": refuse_job, "mean_flat": mean_flat_job,
        "mean_over": mean_over_job}
