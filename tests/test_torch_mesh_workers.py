"""Mesh engines in worker processes (``EngineProxy(mesh_shape=)``) behind
the port's ``Router``, against the live JAX reference, on the CPU: the
reduced fp32 qwen3-next-gdn on the reference's parameters through the
numpy bridge, every mesh a group of gloo ranks that its worker starts.

  * a ``Router`` over a (2,1) and a (1,2) mesh worker gives the streams
    of the reference's one-device ``DecodeEngine`` (the (2,1) worker under
    ``swap_policy="auto"`` with a lease no tick reaches: the sweep's
    broadcast runs every tick); an engine error crosses a mesh worker as
    its own type;
  * prefill handed to decode across topologies: a (1,2) prefill worker
    to a one-device decode worker, a one-device prefill worker to a (1,2)
    decode worker, each router's streams the reference's and each handed
    image within the reference's model-axis tolerance (``TOL``) of the
    port's one-device image of the same request;
  * a ``params_seed`` mesh worker (each rank draws its shards) and a
    ``params`` one (each rank cuts the one-device draw) agree bitwise:
    streams, and a paused image;
  * killing a rank of a mesh worker: ``WorkerDied`` at the router, whose
    queued requests re-home to the other worker and finish.

The workers start once, together, while the reference serves here; each
case runs under a timeout that kills every worker process and fails
rather than hang.
"""
import os
import signal
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ranks as ranks                          # noqa: E402
import torch_mesh_reference as mref                       # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro_torch.bridge import to_torch                   # noqa: E402
from repro_torch.models import lm as tlm                  # noqa: E402
from repro_torch.serving.engine import (DecodeEngine, EngineProxy,  # noqa
                                        Request, Router, WorkerDied)
from repro_torch.tree import leaves                       # noqa: E402

ARCH = "qwen3-next-gdn"
ENGINE = dict(mref.ENGINE, device="cpu")
SPECS = mref.requests(5, True)
TOL = mref.TOL
# (name, mesh shape or None, role, weights: "bridged" / "seed" / "drawn",
# engine settings beside ENGINE)
WORKERS = [
    ("w21", (2, 1), "both", "bridged",
     dict(swap_policy="auto", idle_swap_ms=1e7)),
    ("w12", (1, 2), "both", "bridged", {}),
    ("p12", (1, 2), "prefill", "bridged", {}),
    ("d1", None, "decode", "bridged", {}),
    ("p1", None, "prefill", "bridged", {}),
    ("d12", (1, 2), "decode", "bridged", {}),
    ("s12", (1, 2), "both", "seed", {}),
    ("t12", (1, 2), "both", "drawn", {}),
]


def _reqs(specs=SPECS):
    return [Request(**dict(s)) for s in specs]


def _streams(reqs):
    return [list(r.output) for r in reqs]


def _kill_all(procs):
    for p in procs.values():
        for pid in p.rank_pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass


def _bounded(procs, fn, timeout=90.0):
    """Run ``fn`` in a thread; past ``timeout`` s kill every worker
    process (a blocked read then sees EOF) and fail."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:       # noqa: BLE001 — re-raised below
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        _kill_all(procs)
        t.join(30)
        pytest.fail(f"no result in {timeout} s: the workers were killed")
    if "error" in out:
        raise out["error"]
    return out["value"]


def _handoffs(eng):
    """Each request's handed-off image, by rid, as the router withdraws
    them from ``eng``."""
    got = {}
    real = eng.withdraw_handoff

    def withdraw():
        rec = real()
        if rec is not None:
            got[rec.req.rid] = rec.state
        return rec
    eng.withdraw_handoff = withdraw
    return got


def _one_device_images(cfg, params):
    """The port's one-device prefill engine's handoff image of every
    request of ``SPECS``, by rid."""
    eng = DecodeEngine(cfg, params, role="prefill", **ENGINE)
    for r in _reqs():
        eng.submit(r)
    got = {}
    for _ in range(100):
        eng.step()
        while (rec := eng.withdraw_handoff()) is not None:
            got[rec.req.rid] = rec.state
        if len(got) == len(SPECS):
            return got
    raise AssertionError("the one-device engine handed off too few")


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    jcfg, jp, host = mref.bridged(ARCH)
    cfg, bridged = ranks.config(ARCH), to_torch(host)
    weights = {"bridged": dict(params=bridged),
               "seed": dict(params_seed=0),
               "drawn": dict(params=tlm.init_lm(0, cfg, device="cpu"))}

    def start(name, shape, role, w, kw):
        return name, EngineProxy(cfg, mesh_shape=shape, role=role,
                                 **weights[w], **kw, **ENGINE)
    pool = ThreadPoolExecutor(len(WORKERS))
    futs = [pool.submit(start, *w) for w in WORKERS]
    ref, _ = mref.jserve(JEngine(jcfg, jp, **mref.ENGINE), SPECS)
    images = _one_device_images(cfg, bridged)
    procs, errors = {}, []
    for f in futs:
        try:
            name, p = f.result()
            procs[name] = p
        except Exception as e:          # noqa: BLE001 — raised below
            errors.append(e)
    pool.shutdown()
    try:
        if errors:
            raise errors[0]
        yield dict(ref=ref, images=images, procs=procs)
    finally:
        with ThreadPoolExecutor(max(len(procs), 1)) as stop:
            list(stop.map(lambda p: p.shutdown(), procs.values()))


def test_router_over_mesh_workers_gives_the_reference_streams(run):
    """Router([(2,1) worker, (1,2) worker]): both take requests, every
    stream is the reference's one-device one, each rank ran; an engine
    error crosses the (1,2) worker as a ``KeyError`` and it serves on."""
    w21, w12 = run["procs"]["w21"], run["procs"]["w12"]

    def serve():
        router = Router([w21, w12])
        reqs = _reqs()
        for r in reqs:
            router.submit(r)
        router.run_until_done()
        return router, reqs
    router, reqs = _bounded(run["procs"], serve)
    assert all(r.done for r in reqs)
    assert _streams(reqs) == run["ref"]
    assert all(router.placed) and len(w12.rank_pids) == 2
    m = router.metrics()["per_engine"]
    assert (m[0]["mesh_data"], m[0]["mesh_model"]) == (2, 1)
    assert (m[1]["mesh_data"], m[1]["mesh_model"]) == (1, 2)
    assert m[0]["swap_outs"] == 0           # the lease never ran out
    counts = w21.launch_counts()
    assert len(counts["rank_launches"]) == 2
    assert counts["host_collectives"]["calls"] > 0
    with pytest.raises(KeyError, match="no live request"):
        _bounded(run["procs"], lambda: w12.pause(99))
    assert not w12.dead
    _bounded(run["procs"], w12.step)


@pytest.mark.parametrize("donor,taker", [("p12", "d1"), ("p1", "d12")])
def test_handoff_across_topologies(run, donor, taker):
    """A prefill worker hands every request to a decode worker of another
    topology: the streams are the reference's, every image is the port's
    one-device image within ``TOL`` (its sampler row and token exact)."""
    pre, dec = run["procs"][donor], run["procs"][taker]
    handed = _handoffs(pre)

    def serve():
        router = Router([pre, dec])
        reqs = _reqs()
        for r in reqs:
            router.submit(r)
        router.run_until_done()
        return router, reqs
    router, reqs = _bounded(run["procs"], serve)
    assert _streams(reqs) == run["ref"]
    # the request that finishes at its admit never leaves the prefill side
    moved = [s["rid"] for s in SPECS if s["max_new_tokens"] > 1]
    assert sorted(handed) == moved and router.handoffs == len(moved)
    for rid in moved:
        got, want = handed[rid], run["images"][rid]
        for a, b in zip(leaves(got.caches), leaves(want.caches)):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                       err_msg=f"rid {rid}")
        for a, b in zip(leaves(got.sampler), leaves(want.sampler)):
            assert np.array_equal(a, b), rid
        assert np.array_equal(got.token, want.token), rid


def _paused_image(eng):
    """Serve ``SPECS`` on ``eng`` with request 0 paused after 2 tokens and
    its image withdrawn and readmitted: (streams, the image)."""
    reqs = _reqs()
    for r in reqs:
        eng.submit(r)
    for _ in range(100):
        eng.step()
        if reqs[0].state == "active" and len(reqs[0].output) >= 2:
            break
    eng.pause(0)
    eng.resume(0)
    rec = eng.withdraw_swapped()        # the resume claim's record
    eng.readmit_swapped(rec)
    Router([eng]).run_until_done()
    return _streams(reqs), rec.state


def test_params_and_params_seed_workers_agree_bitwise(run):
    """Each rank of the ``params_seed`` worker draws its own shards; each
    rank of the ``params`` worker cuts the one-device draw of the same
    seed: the same streams, and the same bits of a paused image."""
    s12, t12 = run["procs"]["s12"], run["procs"]["t12"]
    (sa, ia), (sb, ib) = _bounded(run["procs"], lambda: (
        _paused_image(s12), _paused_image(t12)))
    assert sa == sb and all(len(s) for s in sa)
    pairs = list(zip(leaves(ia.caches) + leaves(ia.sampler) + [ia.token],
                     leaves(ib.caches) + leaves(ib.sampler) + [ib.token]))
    assert pairs and all(a.tobytes() == b.tobytes() for a, b in pairs)
    run["seeded"] = sa


def test_killed_rank_raises_worker_died_and_rehomes(run):
    """Rank 1 of a (1,2) worker killed before its first tick: the router
    sees ``WorkerDied``, re-homes the worker's queued requests to the
    other worker, and every stream is the one that worker serves alone."""
    t12, s12 = run["procs"]["t12"], run["procs"]["s12"]
    want = run.get("seeded") or _bounded(
        run["procs"], lambda: _paused_image(s12))[0]
    router = Router([t12, s12], policy="round_robin")
    reqs = _reqs()
    for r in reqs:
        router.submit(r)
    on_t12 = router.placed[0]
    assert on_t12 >= 2
    os.kill(t12.rank_pids[1], signal.SIGKILL)

    def serve():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            router.run_until_done()
        return caught
    caught = _bounded(run["procs"], serve, timeout=60)
    assert any("worker died" in str(w.message) for w in caught)
    assert router.metrics()["dead"] == [0] and router.rehomed == on_t12
    assert all(r.done for r in reqs) and _streams(reqs) == want
    with pytest.raises(WorkerDied):
        t12.step()
    t12.proc.wait(timeout=30)
    assert t12.proc.returncode != 0
