"""A CPU stand-in for the rules a CUDA graph capture enforces on the card,
shared by the tests of the port's programs (``tests/test_torch_graphs.py``,
``tests/test_torch_train.py``).

From its second call on, a ``runtime.graphs.Program`` (the executor's
programs, the trainer's step) may neither make a tensor from host data (a
pageable host-to-device copy, which a capture refuses) nor read a tensor
on the host (a sync, which a capture refuses and a replay would skip).
``guard_programs`` patches torch so that either raises ``HostUse`` inside
such a call.
"""
import torch

from repro_torch.runtime import graphs

# the Tensor methods that read a tensor's value on the host
HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
              "__float__")


class HostUse(AssertionError):
    pass


def _refuse(name):
    def refuse(*args, **kwargs):
        raise HostUse(f"{name} inside a program after its first call")
    return refuse


def guard_programs(monkeypatch) -> dict:
    """Guard every program call after the program's first; returns a dict
    whose ``"guarded"`` entry counts the guarded calls."""
    guarded = {"on": False}

    def as_tensor(data, *args, **kwargs):
        if guarded["on"] and not isinstance(data, torch.Tensor):
            raise HostUse("torch.as_tensor of host data inside a program")
        return real_as_tensor(data, *args, **kwargs)

    real_as_tensor = torch.as_tensor
    real_call = graphs.Program.__call__
    monkeypatch.setattr(torch, "as_tensor", as_tensor)
    for name in ("tensor", "from_numpy"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, _n=name, **k: (
            _refuse(f"torch.{_n}")() if guarded["on"] else _r(*a, **k)))
    for name in HOST_READS:
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, _r=real,
                            _n=name, **k: (
                                _refuse(f"Tensor.{_n}")() if guarded["on"]
                                else _r(self, *a, **k)))

    calls = {"guarded": 0}

    def call(prog):
        if prog.calls == 0:
            return real_call(prog)
        guarded["on"] = True
        calls["guarded"] += 1
        try:
            return real_call(prog)
        finally:
            guarded["on"] = False

    monkeypatch.setattr(graphs.Program, "__call__", call)
    return calls
