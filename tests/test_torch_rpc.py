"""The port's process-boundary engines (``repro_torch.serving.rpc``) on the
CPU: worker processes behind ``EngineProxy``, each with one intra-op
thread (``OMP_NUM_THREADS=1``).

The reference's three subprocess tests (``tests/test_disagg.py``):

  * prefill / decode parity across processes: bridged params shipped as
    host numpy, the streams bitwise the live JAX reference engine's,
    handoffs through the pipes, time stamps on the caller's own
    ``Request`` objects, clean exits;
  * worker death: a killed worker's queued requests re-home to the
    surviving engine and finish;
  * engine errors cross the pipe as the reference's exception types, and
    the worker keeps serving.

Beside them: a ``params_seed`` worker gives the streams of an in-process
engine on ``lm.init_lm(seed, cfg, device="cpu")``; a worker's own prints
never reach the frame pipe; a worker that cannot build its engine raises
in the caller; the serve CLI's ``--rpc --workers 2 --roles
prefill,decode`` prints the single-engine run's streams and one handoff
per request.
"""
import io
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                    # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.serving.engine import DecodeEngine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest      # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_torch                   # noqa: E402
from repro_torch.launch import serve as tserve            # noqa: E402
from repro_torch.models import lm as tlm                  # noqa: E402
from repro_torch.serving import rpc                       # noqa: E402
from repro_torch.serving.engine import (DecodeEngine, EngineProxy,  # noqa
                                        Request, Router, WorkerDied)

ENGINE = dict(max_slots=2, max_len=64, decode_block=2, prefill_chunk=8,
              device="cpu")


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """Workers inherit one intra-op thread; so does this process."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODEL = {}


def _model():
    if not _MODEL:
        jcfg = jconfigs.get_arch("qwen3-next-gdn").reduced()
        jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
        _MODEL.update(jcfg=jcfg, jp=jp,
                      tcfg=tconfigs.get_arch("qwen3-next-gdn").reduced(),
                      tp=to_torch(jax.tree.map(np.asarray, jp)))
    return _MODEL


def _reqs(n, R=Request, max_new=8):
    """Mixed greedy / stochastic sessions plus one admit-boundary
    finisher."""
    out = [R(rid=i, prompt=np.arange(1, 7 + 3 * i, dtype=np.int32),
             max_new_tokens=max_new + i,
             temperature=0.8 if i % 2 == 0 else 0.0,
             top_k=10 if i % 2 == 0 else 0,
             top_p=0.9 if i % 2 == 0 else 1.0)
           for i in range(n)]
    out.append(R(rid=n, prompt=np.arange(1, 9, dtype=np.int32),
                 max_new_tokens=1))
    return out


def _serve(engine, reqs):
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    assert all(r.done for r in reqs)
    return [list(r.output) for r in reqs]


def _shutdown(*proxies):
    for p in proxies:
        p.shutdown()
    for p in proxies:
        assert p.proc.poll() is not None    # the worker really exited


def test_hostify_round_trips_params_bitwise():
    """Weights cross the pipe as the tree's structure and its leaves' bits
    (bf16 as ``V2`` words): no tensor is pickled, the tree comes back
    bitwise with the port's nesting."""
    cfg = tconfigs.get_arch("qwen3-next-gdn").reduced().replace(
        act_dtype="bfloat16")
    params = tlm.init_lm(3, cfg, device="cpu")
    host = rpc._hostify(params)
    back = rpc._torchify(rpc.wire.decode(rpc.wire.encode(host),
                                         allow_pickle=False), "cpu")
    a, b = rpc.leaves(params), rpc.leaves(back)
    assert len(a) == len(b) and any(t.dtype == torch.bfloat16 for t in a)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bfloat16
                           else x, y.view(torch.uint8)
                           if y.dtype == torch.bfloat16 else y)
    assert rpc.wire.structure(back) == rpc.wire.structure(params)


def test_rpc_disagg_parity():
    """Two worker processes (prefill + decode) on bridged params shipped as
    host numpy: the streams bitwise the live reference engine's, the
    handoffs through the pipes, time stamps on the caller's requests,
    clean shutdown."""
    m = _model()
    ref = _serve(JEngine(m["jcfg"], m["jp"], max_slots=2, max_len=64,
                         decode_block=2, prefill_chunk=8),
                 _reqs(3, JRequest))
    with ThreadPoolExecutor(2) as pool:     # the two start-ups overlap
        pre, dec = pool.map(lambda role: EngineProxy(
            m["tcfg"], m["tp"], role=role, **ENGINE), ("prefill", "decode"))
    try:
        assert (pre.role, dec.role) == ("prefill", "decode")
        assert pre.max_len == 64 and pre.max_slots == 2
        assert pre.device == dec.device == "cpu"
        router = Router([pre, dec])
        reqs = _reqs(3)
        assert _serve(router, reqs) == ref
        mt = router.metrics()
        assert mt["handoffs"] == 3 and mt["handoffs_out"] == 3
        assert mt["per_engine"][0]["decoded_tokens"] == 0
        assert mt["per_engine"][1]["stage_dispatches"] == 0
        for r in reqs:
            assert r.ttft_s is not None and r.ttft_s > 0
            assert r.latency_s is not None and r.latency_s > 0
        # each worker reports its own launches (none: the CPU runs the
        # kernels' plain versions) and the programs its role ran
        lp, ld = pre.launch_counts(reset=True), dec.launch_counts()
        for snap in (lp, ld):
            assert snap["launches"] and set(snap["launches"].values()) == {0}
        ran = [{key[0] for key, n in s["program_calls"].items() if n}
               for s in (lp, ld)]
        assert ran[0] & {"bscan", "badmit"} and "decode" not in ran[0]
        assert "decode" in ran[1] and not ran[1] & {"bscan", "badmit"}
    finally:
        _shutdown(pre, dec)
    assert pre.proc.returncode == dec.proc.returncode == 0


def test_params_seed_worker_is_the_in_process_engine():
    """A worker given ``params_seed`` draws the weights with the port's
    ``lm.init_lm(seed, cfg, device=...)``: its streams are those of an
    in-process engine on ``lm.init_lm(seed, cfg, device="cpu")``."""
    cfg = _model()["tcfg"]
    want = _serve(DecodeEngine(cfg, tlm.init_lm(5, cfg, device="cpu"),
                               **ENGINE), _reqs(3))
    prox = EngineProxy(cfg, params_seed=5, **ENGINE)
    try:
        assert _serve(Router([prox]), _reqs(3)) == want
        assert prox.metrics()["requests"] == 4
    finally:
        _shutdown(prox)


def test_rpc_worker_death_rehomes_queued():
    """Killing a worker: the router sees EOF on its channel, marks the
    engine dead, re-homes its queued requests to the surviving engine and
    finishes them; a dead proxy raises instead of hanging."""
    cfg = _model()["tcfg"]
    params = tlm.init_lm(0, cfg, device="cpu")
    want = _serve(DecodeEngine(cfg, params, **ENGINE), _reqs(3))
    prox = EngineProxy(cfg, params_seed=0, **ENGINE)
    local = DecodeEngine(cfg, params, **ENGINE)
    router = Router([prox, local], policy="round_robin")
    reqs = _reqs(3)
    for r in reqs:
        router.submit(r)
    assert router.placed == [2, 2]
    prox.proc.kill()
    with pytest.warns(RuntimeWarning, match="worker died"):
        done = router.run_until_done()
    assert router.metrics()["dead"] == [0]
    assert router.rehomed == 2
    assert all(r.done for r in reqs)
    assert len(done) == len(reqs)
    assert [list(r.output) for r in reqs] == want
    with pytest.raises(WorkerDied):
        prox.step()
    prox.shutdown()
    assert prox.proc.poll() is not None


def test_rpc_worker_surfaces_engine_errors():
    """Engine exceptions cross the pipe as their own types; the worker
    stays alive.  A worker that cannot build its engine raises in the
    caller and exits."""
    cfg = _model()["tcfg"]
    with ThreadPoolExecutor(1) as pool:     # the failing start-up beside
        bad = pool.submit(EngineProxy, cfg, params_seed=0,
                          role="verifier", **ENGINE)
        prox = EngineProxy(cfg, params_seed=0, role="decode", **ENGINE)
        with pytest.raises(ValueError, match="role must be"):
            bad.result()
    try:
        with pytest.raises(ValueError, match="decode"):
            prox.submit(Request(rid=0, prompt=np.arange(4, dtype=np.int32)))
        with pytest.raises(KeyError, match="no live request"):
            prox.pause(7)
        assert not prox.dead
        prox.step()                     # still serving
        assert prox.metrics()["role"] == "decode"
    finally:
        _shutdown(prox)
    with pytest.raises(ValueError, match="exactly one"):
        EngineProxy(cfg, **ENGINE)
    # a worker serving a (1,1) mesh: the in-process engine's streams, and
    # its engine errors cross the pipe as theirs do
    want = _serve(DecodeEngine(cfg, tlm.init_lm(0, cfg, device="cpu"),
                               **ENGINE), _reqs(3))
    mesh = EngineProxy(cfg, params_seed=0, mesh_shape=(1, 1), **ENGINE)
    try:
        assert _serve(Router([mesh]), _reqs(3)) == want
        assert mesh.metrics()["mesh_data"] == 1
        with pytest.raises(KeyError, match="no live request"):
            mesh.pause(7)
        assert not mesh.dead
    finally:
        _shutdown(mesh)


def test_worker_stdout_carries_only_frames(tmp_path):
    """``rpc.main`` points fd 1 and ``sys.stdout`` at stderr before the
    worker serves: a print from Python and a write to fd 1 land on
    stderr, and stdout holds the frames alone.  So do those of a mesh
    worker's ranks, which it starts after that: each rank prints from
    Python and writes to fd 1 as it builds its engine, and stdout holds
    the init and shutdown replies alone."""
    code = textwrap.dedent("""
        import os, sys
        from repro_torch.serving import rpc, wire

        class Loud(rpc.EngineWorker):
            def serve(self):
                print("from python")
                sys.stdout.flush()
                os.write(1, b"through fd 1\\n")
                wire.write_frame(self.out, wire.encode({"ok": True}))
                return 0

        rpc.EngineWorker = Loud
        sys.exit(rpc.main())
        """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         env={**os.environ, "PYTHONPATH": rpc._SRC},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert rpc.wire.decode(rpc.wire.read_frame(io.BytesIO(out.stdout))) \
        == {"ok": True}
    assert len(out.stdout) == 8 + len(rpc.wire.encode({"ok": True}))
    assert b"from python" in out.stderr and b"through fd 1" in out.stderr

    # a (1,2) mesh worker: the spawned rank imports this script as its
    # main module, so the patched build prints there too
    script = tmp_path / "loud_mesh.py"
    script.write_text(textwrap.dedent("""
        import os, sys
        from repro_torch.serving import rpc

        build = rpc.EngineWorker._build

        def loud(self, init):
            print(f"from python, pid {os.getpid()}")
            sys.stdout.flush()
            os.write(1, f"through fd 1, pid {os.getpid()}\\n".encode())
            return build(self, init)

        rpc.EngineWorker._build = loud
        if __name__ == "__main__":
            sys.exit(rpc.main())
        """))
    cfg = _model()["tcfg"]
    frames = io.BytesIO()
    for msg in ({"cfg": cfg, "params": None, "params_seed": 0,
                 "device": "cpu",
                 "kwargs": {k: v for k, v in ENGINE.items()
                            if k != "device"},
                 "mesh_shape": (1, 2), "mesh_axes": ("data", "model"),
                 "backend": "gloo", "first_card": 0},
                ["shutdown", None]):
        rpc.wire.write_frame(frames, rpc.wire.encode(msg))
    out = subprocess.run([sys.executable, str(script)],
                         input=frames.getvalue(), capture_output=True,
                         env={**os.environ, "PYTHONPATH": rpc._SRC},
                         timeout=180)
    assert out.returncode == 0, out.stderr
    stdout = io.BytesIO(out.stdout)
    init = rpc.wire.decode(rpc.wire.read_frame(stdout))
    assert init["ok"] and len(init["result"]["rank_pids"]) == 2
    assert rpc.wire.decode(rpc.wire.read_frame(stdout))["ok"]
    assert stdout.read() == b""
    for pid in init["result"]["rank_pids"]:
        assert f"from python, pid {pid}".encode() in out.stderr
        assert f"through fd 1, pid {pid}".encode() in out.stderr


def test_serve_cli_rpc_prefill_decode(capsys):
    """``--rpc --workers 2 --roles prefill,decode`` prints the
    single-engine run's streams and one handoff per request."""
    base = ["--arch", "qwen3-next-gdn", "--requests", "4", "--max-new", "6",
            "--slots", "2", "--max-len", "64", "--kernels",
            "--device", "cpu"]

    def streams(out):
        return [line.split(":", 1)[0] + line.rsplit("toks:", 1)[1]
                for line in out.splitlines() if "toks:" in line]

    tserve.main(base)
    plain = streams(capsys.readouterr().out)
    tserve.main(base + ["--rpc", "--workers", "2", "--roles",
                        "prefill,decode"])
    out = capsys.readouterr().out
    assert streams(out) == plain and len(plain) == 4
    assert "topology: 2 worker process(es) on cpu" in out
    assert "roles=prefill,decode" in out
    assert "4 prefill→decode handoffs" in out
