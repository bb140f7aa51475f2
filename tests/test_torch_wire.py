"""The port's wire codec (``repro_torch.serving.wire``) against the
reference's ``repro.serving.wire``, on the CPU.

  * ``encode`` and ``write_frame`` give the reference's bytes for the same
    numpy and python objects (every tag, arrays of every dtype the
    serving state holds, 0-d and non-contiguous arrays, nesting, the
    pickle fallback), and each package decodes the other's bytes;
  * ``encode_request`` gives the reference's bytes for a request of the
    same fields (the port's ``Request`` has the reference's fields in its
    order), and requests, request updates and swap records round-trip;
  * swapped images round-trip bitwise through ``dump_swapped`` /
    ``load_swapped`` (a port engine's image mid-decode, and a bfloat16
    image held as raw 2-byte words), the cache tree's structure coming
    back with the port's NamedTuples, and a spooled file loads with no
    unpickling at all: a pickled field in one is refused.
"""
import io
import pickle

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                    # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.serving import wire as jwire                   # noqa: E402
from repro.serving.scheduler import Request as JRequest   # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_torch                   # noqa: E402
from repro_torch.models import lm as tlm                  # noqa: E402
from repro_torch.serving import wire                      # noqa: E402
from repro_torch.serving.engine import DecodeEngine, Request  # noqa: E402
from repro_torch.serving.executor import SwappedState     # noqa: E402
from repro_torch.serving.scheduler import _Swapped        # noqa: E402
from repro_torch.tree import leaves                       # noqa: E402

_RNG = np.random.default_rng(7)
OBJECTS = [
    None, True, False, 0, -3, 2 ** 62, np.int32(7), np.int64(-9), 1.5,
    np.float32(0.25), float("inf"), "", "swap-3.state", "päge ✓", b"",
    b"\x00\xffbytes", bytearray(b"ab"), [], (), {},
    np.zeros((), np.int32), np.arange(6, dtype=np.int32).reshape(2, 3),
    np.arange(12, dtype=np.float32).reshape(3, 4).T,      # non-contiguous
    _RNG.normal(size=(2, 1, 4, 4)).astype(np.float32),
    np.array([[1, 2]], np.uint32), np.array([[3, 4]], np.int64),
    np.array([True, False]), np.full((1,), -1, np.int32),
    [1, [2.0, ("x", None)], {"k": np.ones((2,), np.float32)}],
    {"state": None, 3: "int key", "nested": {"a": (1, 2), "b": [b"z"]}},
    complex(1, 2),                                          # pickled
]


@pytest.mark.parametrize("obj", OBJECTS, ids=range(len(OBJECTS)))
def test_encode_is_the_references_bytes(obj):
    raw = wire.encode(obj)
    assert raw == jwire.encode(obj)
    a, b = io.BytesIO(), io.BytesIO()
    wire.write_frame(a, raw)
    jwire.write_frame(b, raw)
    assert a.getvalue() == b.getvalue()
    a.seek(0)
    assert wire.read_frame(a) == raw
    for got in (wire.decode(raw), jwire.decode(raw)):
        assert wire.encode(got) == raw      # each decodes the other's


def test_frames_refuse_truncation():
    f = io.BytesIO()
    wire.write_frame(f, b"abcdef")
    for cut in (3, 10):
        with pytest.raises(EOFError):
            wire.read_frame(io.BytesIO(f.getvalue()[:cut]))
    with pytest.raises(EOFError):
        wire.decode(wire.encode("abc")[:-1])


def _request(R, **kw):
    return R(rid=4, prompt=np.arange(1, 9, dtype=np.int32),
             max_new_tokens=12, temperature=0.8, top_k=10, top_p=0.9,
             eos_id=3, priority=2, output=[5, 6], state="swapped",
             t_submit=10.5, t_first=11.25, swapped_s=0.5,
             _swapped_pre_first_s=0.125, t_last_activity=12.0,
             _t_active=11.5, **kw)


def test_request_codec_matches_the_reference():
    raw = wire.encode_request(_request(Request))
    assert raw == jwire.encode_request(_request(JRequest))
    back = wire.decode_request(raw)
    assert isinstance(back, Request)
    assert wire.encode_request(back) == raw
    u = wire.request_update(_request(Request))
    assert wire.encode(u) == jwire.encode(jwire.request_update(
        _request(JRequest)))
    fresh = Request(rid=4, prompt=np.arange(1, 9, dtype=np.int32))
    wire.apply_request_update(fresh, u)
    assert fresh.output == [5, 6] and fresh.swapped_s == 0.5
    assert fresh.ttft_s == pytest.approx(11.25 - 10.5 - 0.125)


@pytest.fixture(scope="module")
def image():
    """A port engine's image of a stochastic request mid-decode, on
    reduced qwen3-next-gdn with the reference's parameters."""
    jcfg = jconfigs.get_arch("qwen3-next-gdn").reduced()
    jp = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    cfg = tconfigs.get_arch("qwen3-next-gdn").reduced()
    eng = DecodeEngine(cfg, to_torch(jax.tree.map(np.asarray, jp)),
                       max_slots=2, max_len=64, decode_block=2,
                       prefill_chunk=8, device="cpu")
    req = Request(rid=0, prompt=np.arange(1, 12, dtype=np.int32),
                  max_new_tokens=10, temperature=0.8, top_k=10)
    eng.submit(req)
    while len(req.output) < 3:
        eng.step()
    eng.pause(0)
    return eng, eng.swapped[0].state


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_image(a, b):
    assert wire.structure(a.caches) == wire.structure(b.caches)
    for x, y in zip(leaves(a.caches), leaves(b.caches)):
        _same_bits(x, y)
    assert a.sampler.keys() == b.sampler.keys()
    for k in a.sampler:
        _same_bits(a.sampler[k], b.sampler[k])
    _same_bits(a.token, b.token)
    assert a.nbytes == b.nbytes


def test_swapped_image_round_trips_bitwise(image, tmp_path):
    eng, sw = image
    path = str(tmp_path / "swap-0.state")
    wire.dump_swapped(path, sw)
    back = wire.load_swapped(path)
    _same_image(back, sw)
    assert back.nbytes == eng.executor.swap_bytes_per_slot
    assert wire.structure(back.caches) == wire.structure(
        tlm.init_caches(eng.cfg, 1, 64, "cpu"))
    assert [type(x).__name__ for x in back.caches[0]] == \
        [type(x).__name__ for x in sw.caches[0]]
    # the reloaded image restores as the original does
    ex = eng.executor
    ex.restore_slot(1, back)
    for t, a in zip(leaves(ex.caches), leaves(sw.caches)):
        _same_bits(t[:, 1:2].numpy(), a)


def test_bf16_image_round_trips_as_raw_words(tmp_path):
    """A bfloat16 cache leaf travels as its 2-byte words (numpy ``V2``,
    what the .npy framing reads back) and restores into a bf16 slot bit
    for bit."""
    from repro_torch.serving.executor import _host_array, _host_tensor
    t = torch.randn(2, 1, 3, 4).to(torch.bfloat16)
    a = _host_array(t)
    assert a.dtype == np.dtype("V2") and a.shape == (2, 1, 3, 4)
    sw = SwappedState(caches={"kv": [a]},
                      sampler={"done": np.zeros((1,), bool)},
                      token=np.zeros((1,), np.int32))
    path = str(tmp_path / "bf16.state")
    wire.dump_swapped(path, sw)
    back = wire.load_swapped(path)
    _same_image(back, sw)
    assert torch.equal(_host_tensor(back.caches["kv"][0], torch.bfloat16,
                                    (2, 1, 3, 4)), t)
    with pytest.raises(ValueError, match="does not fit"):
        _host_tensor(np.zeros((2, 1, 3, 4), np.float16), torch.bfloat16,
                     (2, 1, 3, 4))


def test_spooled_file_loads_without_unpickling(image, tmp_path,
                                               monkeypatch):
    _, sw = image
    path = str(tmp_path / "swap-0.state")
    wire.dump_swapped(path, sw)

    def refuse(*args, **kwargs):
        raise AssertionError("a spooled image unpickled something")

    monkeypatch.setattr(pickle, "loads", refuse)
    monkeypatch.setattr(pickle, "load", refuse)
    _same_image(wire.load_swapped(path), sw)
    # a pickled field (the reference pickles its jax treedef) is refused
    raw = wire.encode({"structure": complex(1, 2), "leaves": [],
                       "sampler": {}, "token": np.zeros((1,), np.int32)})
    with pytest.raises(ValueError, match="pickled"):
        wire.decode_swapped(raw)


def test_swap_record_round_trips(image):
    eng, sw = image
    rec = eng.swapped[0]
    assert rec.pending is None and rec.prefetch is None
    back = wire.decode_swap_record(wire.encode_swap_record(rec))
    assert isinstance(back, _Swapped) and back.t_swap == rec.t_swap
    assert wire.encode_request(back.req) == wire.encode_request(rec.req)
    _same_image(back.state, sw)
    queued = _Swapped(req=_request(Request), state=None, t_swap=1.0)
    assert wire.decode_swap_record(
        wire.encode_swap_record(queued)).state is None
    with pytest.raises(ValueError, match="harvested"):
        wire.encode_swap_record(_Swapped(req=rec.req, state=None,
                                         t_swap=0.0, spool="x"))
