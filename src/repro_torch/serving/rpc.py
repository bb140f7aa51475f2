"""Process-boundary serving engines: ``EngineWorker`` + ``EngineProxy`` (port
of ``repro.serving.rpc``).

In-process engines share one interpreter: a prefill on engine 0 takes
wall-clock from engine 1's decode ticks.  This module puts each engine in
its own **worker process** (one ``Scheduler`` per process, with its own
CUDA context, slot buffers and captured graphs) and fronts it with an
``EngineProxy`` that speaks the whole engine surface the ``Router`` uses,
over length-prefixed frames (``repro_torch.serving.wire``) on the
worker's stdin/stdout pipes.

Protocol (every frame ``wire``-encoded), the reference's:

  * proxy -> worker: one **init** frame (arch config, a params seed or the
    params as host numpy, engine kwargs, the device), then ``[op,
    payload]`` frames;
  * worker -> proxy: one reply per frame, ``{"ok", "result", "updates",
    "status"}``.  ``updates`` carries the mutable progress of every live
    request (output tokens, state, time stamps), which the proxy applies
    to the caller's own ``Request`` objects, as an in-process engine
    mutates them.  ``status`` snapshots the narrow surface the router
    reads between calls (``load``, ``free_slots``, ``handoffs``, ...), so
    reading a proxy property never waits on a round trip.

Pipelined stepping: ``step_begin`` issues a tick without waiting and
``step_drain(block=...)`` collects its reply; at most one step is in
flight, and every other op drains it first.

Worker death: EOF or a broken pipe on the channel raises ``WorkerDied``;
the proxy marks itself dead and ``recover_queued`` hands back the requests
that never left the queue (their prompts live in the caller) and marks
those whose state died with the process ``"failed"``.

What differs from the reference:

  * **Weights.** Params cross the boundary as host numpy (``_hostify``):
    the tree's structure as ``wire.structure`` and its leaves in
    ``tree.leaves`` order, bf16 as raw ``V2`` words.  No tensor and no
    treedef is pickled.  ``draft_params`` travel the same way.
  * **``params_seed``.** The worker draws the weights with the port's
    ``lm.init_lm(seed, cfg, device=...)``, as ``launch/serve.py`` and
    ``chip_smoke.py`` do, so a worker rebuilds bitwise what its parent
    drew on the same device type.  The reference's seed means jax's
    ``init_lm``: one seed gives different weights in the two packages, so
    parity checks against the reference ship bridged params instead.
  * **Device.** The worker builds ``Scheduler(cfg, params, device=...)``
    on ``cuda`` unless the proxy is given ``device="cpu"``.  Each worker
    on the card captures its own CUDA graphs and loads the kernels from
    ``build/kernels/`` (built once; see ``kernels._build``).  A worker
    that cannot build its engine (no card, a failed kernel build) answers
    the init frame with the error, which the proxy raises.
  * **``launch_counts``**, an op the reference lacks: the worker's own
    kernel launch counters and program calls, which an in-process caller
    reads from ``runtime.graphs`` directly.
  * **stdout carries only frames**: the worker keeps a duplicate of fd 1
    for them and points fd 1 (and ``sys.stdout``) at stderr, so nothing
    printed from Python or native code reaches the pipe.

**A worker that serves a mesh** (``EngineProxy(mesh_shape=(D, M),
mesh_axes=("data", "model"))``): the port's mesh is multi-controller,
one process per mesh device, every one running the ``Scheduler`` on the
same requests.  So the worker process is rank 0 of a ``D*M``-rank world
it starts itself (``launch/mesh.py``'s ``init_ranks`` on a store whose
port it binds, so workers started together never race for one port):

  * the other ranks are spawned processes, started after ``main`` points
    fd 1 at stderr, so none of them can write to the frame pipe;
  * the backend is NCCL on the card, rank ``r`` on card ``first_card +
    r`` (the card of the proxy's ``device``), or gloo on the CPU or where
    the caller asks (``backend="gloo"``: every rank on ``device``, the
    programs eager);
  * rank 0 relays every frame (the init frame, then each ``[op,
    payload]``: submits, ticks, pauses, migrations, ``touch``) to the
    other ranks over the mesh's host gloo group
    (``parallel.comm.host_group``), also on an NCCL mesh, before it
    dispatches it itself; every rank dispatches every op, and only rank
    0 replies;
  * after each op the ranks show each other whether it raised (and
    what) and a digest of the scheduler's decisions (``_decisions``):
    ranks that disagree end the worker, so the proxy sees ``WorkerDied``
    rather than a hang in a later collective;
  * weights: ``params_seed`` has each rank draw only its shards
    (``lm.init_lm(seed, cfg, mesh=)``); ``params`` (host numpy) go to
    every rank, which cuts its shards;
  * the swap records that leave the worker are the mesh's host images,
    topology-free: a one-device engine or another mesh takes them, and
    ``readmit_swapped`` cuts an incoming one into the worker's shards;
  * rank 0 watches its ranks and every rank watches rank 0: when one
    exits unasked, the worker exits, its pipe closes and the proxy
    raises ``WorkerDied`` (``recover_queued`` then behaves as for a
    one-device worker); no rank waits on a dead one.

No timeout is set on replies: a first step may sit behind a worker's
graph captures; death is detected by EOF, not silence.

    python -m repro_torch.serving.rpc     # a worker; the proxy spawns it
"""
from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import pathlib
import selectors
import subprocess
import sys
import threading
import traceback
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel import comm
from repro_torch.runtime import graphs
from repro_torch.serving import wire
from repro_torch.serving.executor import _BF16_HOST, _host_array
from repro_torch.tree import leaves

_EXC: Dict[str, type] = {
    "ValueError": ValueError, "KeyError": KeyError,
    "IndexError": IndexError, "TypeError": TypeError,
    "RuntimeError": RuntimeError,
    "NotImplementedError": NotImplementedError,
}

# the directory holding the repro_torch package, put on the worker's path
_SRC = str(pathlib.Path(__file__).resolve().parents[2])


class WorkerDied(RuntimeError):
    """The engine worker process is gone (EOF/broken pipe mid-call)."""


def _hostify(tree) -> Dict[str, Any]:
    """A torch tree as host numpy for the wire: its structure and its
    leaves' bits (bf16 as ``V2`` words)."""
    return {"structure": wire.structure(tree),
            "leaves": [_host_array(t.detach().cpu()) for t in leaves(tree)]}


def _torchify(host: Dict[str, Any], device):
    """Inverse of ``_hostify``: the tree rebuilt on ``device``, bitwise."""
    def leaf(a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if a.dtype == _BF16_HOST:
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    return wire.unflatten(host["structure"],
                          [leaf(a) for a in host["leaves"]])


# ======================================================================
# worker side
# ======================================================================
def _status(eng) -> Dict[str, Any]:
    return {
        "load": eng.load,
        "queue_len": eng.queue_len,
        "free_slots": eng.free_slots,
        "staging_len": eng.staging_len,
        "resume_len": eng.resume_len,
        "idle_capacity": eng.idle_capacity,
        "handoffs": eng.handoffs,
    }


def _decisions(eng) -> int:
    """A digest of the scheduler's decisions so far (slots, queues,
    paging, emitted counts): the ranks of a mesh must agree on it after
    every op."""
    return zlib.crc32(repr((
        sorted((s, r.rid, len(r.output)) for s, r in eng.active.items()),
        list(eng.free), [r.rid for r in eng.queue],
        [(st.req.rid, st.buf, st.ready) for st in eng._stagings],
        sorted(eng.swapped), list(eng.resume_q), list(eng._handoff_q),
        eng.ticks, eng.decode_steps)).encode())


def _mesh_setup(init: Dict[str, Any]) -> Dict[str, Any]:
    """The mesh a worker's init frame asks for: its shape, backend, world
    size and first card (checked before any rank starts)."""
    from repro_torch.launch import mesh as mesh_mod
    shape = tuple(int(n) for n in init["mesh_shape"])
    axes = tuple(init.get("mesh_axes") or ("data", "model"))
    if axes != ("data", "model"):
        raise ValueError(f"a serving mesh has axes ('data', 'model'), got "
                         f"{axes}")
    device = init.get("device")
    backend = init.get("backend") or (
        "gloo" if str(device).startswith("cpu") else "nccl")
    world = shape[0] * shape[1]
    first = int(init.get("first_card") or 0)
    if backend == "nccl":
        mesh_mod.validate_mesh_shape(
            shape, axes, device_count=max(torch.cuda.device_count() - first,
                                          0))
    else:
        mesh_mod.validate_mesh_shape(shape, axes, device_count=world)
    return {"shape": shape, "backend": backend, "world": world,
            "first_card": first}


class EngineWorker:
    """Hosts one ``Scheduler`` and serves the frame protocol on a pair of
    binary streams (``python -m repro_torch.serving.rpc``: stdin and
    stdout pipes, stdout reserved for frames).  On a mesh it is rank 0,
    and ``_rank_main`` runs the same dispatch on each other rank."""

    def __init__(self, inp, out):
        self.inp = inp
        self.out = out
        self.eng = None
        self.reqs: Dict[int, Any] = {}      # rid -> live worker-side Request
        self.mesh = None        # this rank's DeviceMesh, when serving one
        self.host = None        # its host group (the relay)
        self.procs: List[Any] = []          # rank 0: the other ranks
        self.closing = threading.Event()    # rank 0: the ranks may exit

    # ------------------------------------------------------------ setup
    def _build(self, init: Dict[str, Any]):
        from repro_torch import device as _device
        from repro_torch.models import lm
        from repro_torch.serving.scheduler import Scheduler

        cfg = init["cfg"]
        kwargs = dict(init.get("kwargs") or {})
        device = init.get("device")
        if self.mesh is not None:
            kwargs["mesh"] = self.mesh
            if self.backend == "nccl":
                device = f"cuda:{torch.cuda.current_device()}"
            elif kwargs.get("cuda_graphs") is None:
                kwargs["cuda_graphs"] = False   # gloo's collectives are
                                                # host calls
        device = _device.resolve(device)
        if init.get("params_seed") is not None:
            params = lm.init_lm(init["params_seed"], cfg, device=device,
                                mesh=self.mesh)
        else:
            params = _torchify(init["params"], device)
        if kwargs.get("draft_params") is not None:
            kwargs["draft_params"] = _torchify(kwargs["draft_params"],
                                               device)
        self.eng = Scheduler(cfg, params, device=device, **kwargs)
        return {"max_len": self.eng.max_len, "role": self.eng.role,
                "max_slots": self.eng.max_slots,
                "device": str(self.eng.executor.device),
                "rank_pids": [os.getpid()] + [p.pid for p in self.procs]}

    # ------------------------------------------------------------- mesh
    def _start_ranks(self, setup: Dict[str, Any]):
        """Rank 0: spawn ranks 1.. (each joins through this process's
        store), join the group, build the mesh and its host group, and
        watch the ranks from a thread."""
        from repro_torch.launch import mesh as mesh_mod
        store = mesh_mod.host_store(setup["world"])
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, setup, store.port))
                      for r in range(1, setup["world"])]
        for p in self.procs:
            p.start()
        threading.Thread(target=self._watch_ranks, daemon=True).start()
        self._join_mesh(0, setup, store)

    def _join_mesh(self, rank: int, setup: Dict[str, Any], store):
        from repro_torch.launch import mesh as mesh_mod
        self.backend = setup["backend"]
        mesh_mod.init_ranks(rank, setup["world"], store.port, self.backend,
                            first_card=setup["first_card"], store=store)
        self.mesh = mesh_mod.make_serving_mesh(*setup["shape"])
        self.host = comm.host_group(self.mesh)

    def _watch_ranks(self):
        """Rank 0's watch: the first rank to exit unasked ends the worker
        (and the others with it), so nothing waits on a dead rank."""
        ended = multiprocessing.connection.wait(
            [p.sentinel for p in self.procs])
        if self.closing.is_set():
            return
        dead = []
        for r, p in enumerate(self.procs, 1):
            if p.sentinel in ended:
                p.join(timeout=5)
                dead.append((r, p.exitcode))
        _fatal(f"rank(s) {dead} (rank, exit code) exited", self.procs)

    def _agree(self, op: str, err: Optional[Tuple]):
        """After an op: every rank's (raised, what, decisions) must be rank
        0's; else the worker ends (rank 0) or waits to be ended."""
        if self.host is None or self.host.size == 1:
            return
        mine = (0 if err is None else 1,
                0 if err is None else zlib.crc32(err[0].encode()),
                0 if self.eng is None else _decisions(self.eng))
        got = self.host.gather_ints(mine)
        if any(g != got[0] for g in got):
            if self.host.index == 0:
                _fatal(f"the ranks disagree after op {op!r}: (raised, "
                       f"error, decisions digest) per rank {got}",
                       self.procs)
            threading.Event().wait()        # rank 0 is ending the worker

    def _stop_ranks(self):
        """Rank 0: release the ranks (a stop relayed), then reap them."""
        self.closing.set()
        if self.host is not None:
            self.host.broadcast_bytes(None)
        self._reap_ranks()

    def _reap_ranks(self):
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        if self.mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
            self.mesh = None

    # --------------------------------------------------------- dispatch
    def _dispatch(self, op: str, payload) -> Any:
        eng = self.eng
        if op == "submit":
            req = wire.decode_request(payload)
            eng.submit(req)
            self.reqs[req.rid] = req
            return None
        if op == "step":
            eng.step()
            return None
        if op == "pause":
            eng.pause(payload)
            return None
        if op == "resume":
            eng.resume(payload)
            return None
        if op == "touch":
            eng.touch(payload)
            return None
        if op == "withdraw":
            req = eng.withdraw(oldest=bool(payload))
            if req is None:
                return None
            self.reqs.pop(req.rid, None)
            return wire.request_update(req)
        if op == "readmit":
            req = wire.decode_request(payload)
            eng.readmit(req)
            self.reqs[req.rid] = req
            return None
        if op in ("withdraw_swapped", "withdraw_handoff"):
            rec = (eng.withdraw_swapped() if op == "withdraw_swapped"
                   else eng.withdraw_handoff())
            if rec is None:
                return None
            self.reqs.pop(rec.req.rid, None)
            return wire.encode_swap_record(rec)
        if op == "readmit_swapped":
            rec = wire.decode_swap_record(payload)
            eng.readmit_swapped(rec)
            self.reqs[rec.req.rid] = rec.req
            return None
        if op == "flush_swaps":
            eng.flush_swaps()
            return None
        if op == "metrics":
            return eng.metrics()
        if op == "launch_counts":
            counts = graphs.launch_counts()
            out = {"launches": counts,
                   "program_calls": {key: p.calls for key, p in
                                     eng.executor._programs.items()}}
            if self.host is not None:       # every rank's, in rank order
                out["rank_launches"] = [wire.decode(self.host.broadcast_bytes(
                    wire.encode(counts) if r == self.host.index else None,
                    src=r)) for r in range(self.host.size)]
            # this rank's host-group traffic: the relay, the ranks'
            # agreement after each op and the idle sweep's broadcasts
            out["host_collectives"] = {
                k: comm.stats[f"host_{k}"]
                for k in ("calls", "seconds", "bytes")}
            if payload:
                graphs.add_launches(counts, -1)
                comm.reset_stats()
            return out
        if op == "reset_metrics":
            eng.reset_metrics()
            return None
        if op == "shutdown":
            return None
        raise ValueError(f"rpc: unknown op {op!r}")

    def _updates(self) -> List[Dict[str, Any]]:
        ups = []
        for rid, req in list(self.reqs.items()):
            ups.append(wire.request_update(req))
            if req.done:        # final update sent: the proxy's mirror
                del self.reqs[rid]      # keeps the finished object
        return ups

    def _reply(self, ok: bool, result=None, err: Optional[Tuple] = None):
        msg = {"ok": ok, "result": result,
               "updates": self._updates() if self.eng is not None else [],
               "status": _status(self.eng) if self.eng is not None
               else None}
        if err is not None:
            msg["err"], msg["msg"] = err
        wire.write_frame(self.out, wire.encode(msg))

    def _run(self, op: str, payload):
        """Dispatch one op: (result, None) or (None, (error type,
        message))."""
        try:
            return self._dispatch(op, payload), None
        except Exception as e:      # reported to the caller, who raises
            return None, (type(e).__name__, str(e))

    # ------------------------------------------------------------- loop
    def serve(self) -> int:
        try:
            raw = wire.read_frame(self.inp)
        except EOFError:
            return 0
        init = wire.decode(raw)
        err = None
        if init.get("mesh_shape") is not None:
            try:
                self._start_ranks(_mesh_setup(init))
            except Exception as e:      # no mesh: fatal, nothing to relay
                self.closing.set()
                self._reply(False, err=(type(e).__name__, str(e)))
                return 1
            self.host.broadcast_bytes(raw)
        try:
            info = self._build(init)
        except Exception as e:          # init failure is fatal
            err = (type(e).__name__, str(e))
        self._agree("init", err)
        if err is not None:
            self._reply(False, err=err)
            self._stop_ranks()
            return 1
        self._reply(True, result=info)
        while True:
            try:
                raw = wire.read_frame(self.inp)
            except EOFError:            # proxy closed the pipe: done
                self._stop_ranks()
                return 0
            op, payload = wire.decode(raw)
            if self.host is not None:
                if op == "shutdown":
                    self.closing.set()
                self.host.broadcast_bytes(raw)
            result, err = self._run(op, payload)
            self._agree(op, err)
            if err is None:
                self._reply(True, result=result)
            else:
                self._reply(False, err=err)
            if op == "shutdown":
                self._reap_ranks()
                return 0


def _fatal(why: str, procs):
    """End a mesh worker: say why on stderr, kill the other ranks, exit
    (the proxy sees the pipe close)."""
    print(f"rpc mesh worker {os.getpid()}: {why}; ending the worker",
          file=sys.stderr, flush=True)
    for p in procs:
        try:
            p.kill()
        except Exception:
            pass
    os._exit(1)


def _watch_parent():
    """A rank's watch on rank 0: its exit ends this rank."""
    multiprocessing.connection.wait(
        [multiprocessing.parent_process().sentinel])
    os._exit(1)


def _rank_main(rank: int, setup: Dict[str, Any], port: int):
    """Rank ``rank`` (> 0) of a mesh worker: join rank 0's group, then
    dispatch every frame rank 0 relays until a stop or ``shutdown``.
    Nothing here writes a frame; its prints go to the worker's stderr."""
    from repro_torch.launch import mesh as mesh_mod
    threading.Thread(target=_watch_parent, daemon=True).start()
    w = EngineWorker(None, None)
    w._join_mesh(rank, setup, mesh_mod.host_store(setup["world"], port))
    raw = w.host.broadcast_bytes(None)
    err = None
    try:
        w._build(wire.decode(raw))
    except Exception as e:
        traceback.print_exc()
        err = (type(e).__name__, str(e))
    w._agree("init", err)
    while err is None:
        raw = w.host.broadcast_bytes(None)
        if raw is None:             # rank 0 stops: its proxy is gone
            break
        op, payload = wire.decode(raw)
        _, e = w._run(op, payload)
        w._agree(op, e)
        w.reqs = {rid: r for rid, r in w.reqs.items() if not r.done}
        if op == "shutdown":
            break
    else:
        w.host.broadcast_bytes(None)    # rank 0's stop after a failed init
    w._reap_ranks()
    sys.stderr.flush()
    os._exit(0)             # nothing left to flush; skip the slow teardown


# ======================================================================
# proxy side
# ======================================================================
class EngineProxy:
    """Router-facing handle on an ``EngineWorker`` subprocess.  Speaks the
    in-process engine surface (``submit`` / ``step`` / ``pause`` /
    ``resume`` / ``touch`` / ``withdraw*`` / ``readmit*`` / ``metrics``
    ...) plus the pipelined ``step_begin`` / ``step_drain`` pair the
    router uses to tick workers concurrently.  Arguments are
    ``Scheduler``'s; pass ``params_seed`` instead of ``params`` to have
    the worker draw the weights itself.  ``device`` is the worker's
    (``cuda`` unless ``"cpu"`` is asked for).

    ``mesh_shape=(D, M)`` (axes ``mesh_axes``, ``("data", "model")``) has
    the worker serve a mesh of ``D*M`` ranks it starts itself: NCCL ranks
    on the cards from ``device``'s on (``cuda:k``: ``k``, ``k+1``, ...),
    or, with ``backend="gloo"`` (the default with ``device="cpu"``), gloo
    ranks all on ``device``, eager unless ``cuda_graphs`` says otherwise.
    ``rank_pids`` lists its ranks' process ids, rank 0 (``proc``) first."""

    def __init__(self, cfg, params=None, *, params_seed: Optional[int] = None,
                 device=None, mesh_shape=None, mesh_axes=None,
                 backend: Optional[str] = None, **engine_kwargs):
        if (params is None) == (params_seed is None):
            raise ValueError("EngineProxy: pass exactly one of params / "
                             "params_seed")
        if backend not in (None, "nccl", "gloo"):
            raise ValueError(f"EngineProxy: backend must be 'nccl' or "
                             f"'gloo', got {backend!r}")
        self.cfg = cfg
        self.mesh_shape = None if mesh_shape is None else tuple(mesh_shape)
        self.role = engine_kwargs.get("role", "both")
        self.dead = False
        self._reqs: Dict[int, Any] = {}     # mirror: rid -> caller's Request
        self._status: Dict[str, Any] = {
            "load": 0, "queue_len": 0, "free_slots": 0, "staging_len": 0,
            "resume_len": 0, "idle_capacity": 0, "handoffs": 0}
        self._inflight_step = False
        if engine_kwargs.get("draft_params") is not None:
            engine_kwargs["draft_params"] = _hostify(
                engine_kwargs["draft_params"])
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_SRC, env.get("PYTHONPATH")) if p)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serving.rpc"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self.proc.stdout, selectors.EVENT_READ)
        init = {"cfg": cfg,
                "params": None if params is None else _hostify(params),
                "params_seed": params_seed,
                "device": None if device is None else str(device),
                "kwargs": engine_kwargs,
                "mesh_shape": self.mesh_shape,
                "mesh_axes": (None if mesh_axes is None
                              else tuple(mesh_axes)),
                "backend": backend,
                "first_card": (torch.device(device).index or 0
                               if device is not None
                               and str(device).startswith("cuda") else 0)}
        try:
            self._write(wire.encode(init))
            info = self._read_reply()       # waits through the engine build
        except Exception:                   # the worker failed to start
            self._reap()
            raise
        self.max_len = info["max_len"]
        self.max_slots = info["max_slots"]
        self.role = info["role"]
        self.device = info["device"]
        self.rank_pids = info["rank_pids"]

    # ---------------------------------------------------------- channel
    def _write(self, payload: bytes):
        try:
            wire.write_frame(self.proc.stdin, payload)
        except (BrokenPipeError, OSError) as e:
            self._die(e)

    def _read_reply(self):
        try:
            reply = wire.decode(wire.read_frame(self.proc.stdout))
        except (EOFError, OSError) as e:
            self._die(e)
        if reply.get("status") is not None:
            self._status = reply["status"]
        for u in reply.get("updates") or ():
            req = self._reqs.get(u["rid"])
            if req is not None:
                wire.apply_request_update(req, u)
        if not reply["ok"]:
            exc = _EXC.get(reply.get("err", ""), RuntimeError)
            raise exc(f"[worker] {reply.get('msg', '')}")
        return reply["result"]

    def _die(self, cause):
        self.dead = True
        self._inflight_step = False
        try:
            self.proc.kill()
        except OSError:
            pass
        raise WorkerDied(f"engine worker pid {self.proc.pid} died: "
                         f"{cause}") from cause

    def _call(self, op: str, payload=None):
        if self.dead:
            raise WorkerDied(f"engine worker pid {self.proc.pid} is dead")
        self.step_drain(block=True)         # at most one frame in flight
        self._write(wire.encode([op, payload]))
        return self._read_reply()

    # ------------------------------------------------- pipelined ticking
    def step_begin(self):
        """Issue one tick without waiting for it; a no-op while a tick is
        in flight (the worker paces itself)."""
        if self.dead:
            raise WorkerDied(f"engine worker pid {self.proc.pid} is dead")
        if self._inflight_step:
            return
        self._write(wire.encode(["step", None]))
        self._inflight_step = True

    def step_drain(self, *, block: bool) -> bool:
        """Collect the in-flight tick's reply if there is one: with
        ``block=False`` return False when it has not arrived, with
        ``block=True`` wait for it.  True when a reply was consumed."""
        if not self._inflight_step:
            return False
        if not block and not self._sel.select(timeout=0):
            return False
        self._inflight_step = False
        self._read_reply()
        return True

    def step(self):
        self.step_begin()
        self.step_drain(block=True)

    # ------------------------------------------------------- engine surface
    def submit(self, req):
        self._reqs[req.rid] = req
        try:
            self._call("submit", wire.encode_request(req))
        except Exception:
            if not req.done and req.state in ("new", "failed"):
                self._reqs.pop(req.rid, None)
            raise

    def withdraw(self, *, oldest: bool = False):
        u = self._call("withdraw", oldest)
        if u is None:
            return None
        req = self._reqs.pop(u["rid"])
        wire.apply_request_update(req, u)
        return req

    def readmit(self, req):
        self._reqs[req.rid] = req
        self._call("readmit", wire.encode_request(req))

    def pause(self, rid: int):
        self._call("pause", rid)
        return self._reqs[rid]

    def resume(self, rid: int):
        self._call("resume", rid)
        return self._reqs[rid]

    def touch(self, rid: int):
        self._call("touch", rid)

    def _withdraw_record(self, op: str):
        raw = self._call(op)
        if raw is None:
            return None
        rec = wire.decode_swap_record(raw)
        # hand back the caller's own Request, not the wire copy: the
        # router moves records between engines while clients keep
        # polling the object they submitted
        mine = self._reqs.pop(rec.req.rid, None)
        if mine is not None:
            wire.apply_request_update(mine, wire.request_update(rec.req))
            rec.req = mine
        return rec

    def withdraw_swapped(self):
        return self._withdraw_record("withdraw_swapped")

    def withdraw_handoff(self):
        return self._withdraw_record("withdraw_handoff")

    def readmit_swapped(self, rec):
        self._reqs[rec.req.rid] = rec.req
        self._call("readmit_swapped", wire.encode_swap_record(rec))

    def flush_swaps(self):
        self._call("flush_swaps")

    def metrics(self) -> Dict[str, Any]:
        return self._call("metrics")

    def reset_metrics(self):
        self._call("reset_metrics")

    def launch_counts(self, *, reset: bool = False) -> Dict[str, Any]:
        """The worker process's kernel launches (``"launches"``, keyed as
        ``graphs.launch_counts``; zeroed after the read when ``reset``)
        and its engine's calls per program key (``"program_calls"``,
        never reset), so a caller can tie the launches to the work that
        made them.  A mesh worker adds ``"rank_launches"``: every rank's
        launches, in rank order (rank 0's are ``"launches"``)."""
        return self._call("launch_counts", reset)

    # ------------------------------------------------- router narrow surface
    @property
    def load(self) -> int:
        return self._status["load"]

    @property
    def queue_len(self) -> int:
        return self._status["queue_len"]

    @property
    def free_slots(self) -> int:
        return self._status["free_slots"]

    @property
    def staging_len(self) -> int:
        return self._status["staging_len"]

    @property
    def resume_len(self) -> int:
        return self._status["resume_len"]

    @property
    def idle_capacity(self) -> int:
        return self._status["idle_capacity"]

    @property
    def handoffs(self) -> int:
        return self._status["handoffs"]

    def owns(self, rid: int) -> bool:
        req = self._reqs.get(rid)
        return req is not None and not req.done

    def done_requests(self):
        return [r for r in self._reqs.values() if r.done]

    # ---------------------------------------------------- death recovery
    def recover_queued(self):
        """After the worker died: split the mirror into requests that never
        left the queue (returned for re-homing: their prompts live here)
        and requests whose state died with the process (marked
        ``"failed"``)."""
        queued, lost = [], []
        for req in self._reqs.values():
            if req.done:
                continue
            if req.state in ("new", "queued"):
                queued.append(req)
            else:
                req.state = "failed"
                lost.append(req)
        for req in queued:      # re-homed requests leave this mirror, so
            self._reqs.pop(req.rid, None)   # only the new owner reports
        return queued, lost                 # them in done_requests()

    # ----------------------------------------------------------- teardown
    def shutdown(self):
        """Graceful stop: drain an in-flight tick, send shutdown, reap the
        process.  Safe to call twice and after death."""
        if not self.dead:
            try:
                self._call("shutdown")
            except WorkerDied:
                pass
        self._reap()

    def _reap(self):
        self.dead = True
        for stream in (self.proc.stdin, self.proc.stdout):
            try:
                stream.close()
            except OSError:
                pass
        self._sel.close()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()

    def __del__(self):
        try:
            if self.proc.poll() is None:
                self.proc.kill()
        except Exception:
            pass


def main() -> int:
    # frames go to a duplicate of fd 1; fd 1 itself and sys.stdout now
    # point at stderr, so a print from Python or native code cannot
    # corrupt the protocol
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    return EngineWorker(sys.stdin.buffer, out).serve()


if __name__ == "__main__":
    sys.exit(main())
