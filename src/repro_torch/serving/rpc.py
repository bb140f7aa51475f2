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

No timeout is set on replies: a first step may sit behind a worker's
graph captures; death is detected by EOF, not silence.

    python -m repro_torch.serving.rpc     # a worker; the proxy spawns it
"""
from __future__ import annotations

import os
import pathlib
import selectors
import subprocess
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

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


class EngineWorker:
    """Hosts one ``Scheduler`` and serves the frame protocol on a pair of
    binary streams (``python -m repro_torch.serving.rpc``: stdin and
    stdout pipes, stdout reserved for frames)."""

    def __init__(self, inp, out):
        self.inp = inp
        self.out = out
        self.eng = None
        self.reqs: Dict[int, Any] = {}      # rid -> live worker-side Request

    # ------------------------------------------------------------ setup
    def _build(self, init: Dict[str, Any]):
        from repro_torch import device as _device
        from repro_torch.models import lm
        from repro_torch.serving.scheduler import Scheduler

        cfg, device = init["cfg"], _device.resolve(init.get("device"))
        if init.get("params_seed") is not None:
            params = lm.init_lm(init["params_seed"], cfg, device=device)
        else:
            params = _torchify(init["params"], device)
        kwargs = dict(init.get("kwargs") or {})
        if kwargs.get("draft_params") is not None:
            kwargs["draft_params"] = _torchify(kwargs["draft_params"],
                                               device)
        self.eng = Scheduler(cfg, params, device=device, **kwargs)
        return {"max_len": self.eng.max_len, "role": self.eng.role,
                "max_slots": self.eng.max_slots,
                "device": str(self.eng.executor.device)}

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
            if payload:
                graphs.add_launches(counts, -1)
            return {"launches": counts,
                    "program_calls": {key: p.calls for key, p in
                                      eng.executor._programs.items()}}
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

    # ------------------------------------------------------------- loop
    def serve(self) -> int:
        try:
            init = wire.decode(wire.read_frame(self.inp))
        except EOFError:
            return 0
        try:
            info = self._build(init)
        except Exception as e:          # init failure is fatal
            self._reply(False, err=(type(e).__name__, str(e)))
            return 1
        self._reply(True, result=info)
        while True:
            try:
                frame = wire.read_frame(self.inp)
            except EOFError:            # proxy closed the pipe: done
                return 0
            op, payload = wire.decode(frame)
            try:
                result = self._dispatch(op, payload)
            except Exception as e:      # reported to the caller, who raises
                self._reply(False, err=(type(e).__name__, str(e)))
            else:
                self._reply(True, result=result)
            if op == "shutdown":
                return 0


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
    (``cuda`` unless ``"cpu"`` is asked for)."""

    def __init__(self, cfg, params=None, *, params_seed: Optional[int] = None,
                 device=None, mesh_shape=None, mesh_axes=None,
                 **engine_kwargs):
        if (params is None) == (params_seed is None):
            raise ValueError("EngineProxy: pass exactly one of params / "
                             "params_seed")
        if mesh_shape is not None or mesh_axes is not None:
            raise NotImplementedError(
                "EngineProxy(mesh_shape=) is not ported to repro_torch yet: "
                "ROADMAP queue 1 item 4d (a worker serving a mesh; "
                "in-process engines take mesh=)")
        self.cfg = cfg
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
                "kwargs": engine_kwargs}
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
        made them."""
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
