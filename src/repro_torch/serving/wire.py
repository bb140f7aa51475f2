"""Wire codec for the serving stack's host-boundary images (port of
``repro.serving.wire``).

One serializer for every path that moves a request's state across a
process or storage boundary: the spill-to-disk tier of state paging
(``Scheduler._spill`` / ``_load_spill``) and the frames of the worker
processes' protocol (``serving.rpc``).

The generic codec is byte for byte the reference's: a tiny tagged binary
encoding (one-byte tags, 8-byte big-endian lengths and numbers) whose
arrays are framed with ``np.lib.format`` (the ``.npy`` encoding), which
keeps dtype, shape and byte order exactly; ``write_frame`` /
``read_frame`` length-prefix a message with 8 big-endian bytes.  Objects
the codec has no tag for fall back to pickle, as in the reference.

The swapped-image codec differs from the reference's in one place: the
reference pickles the cache tree's jax treedef, which this package cannot
load.  Here the tree's structure is itself encoded with the generic codec
(nested dicts, lists, tuples and NamedTuple names and fields), the
leaves follow in ``repro_torch.tree.leaves`` order, and the decoder
refuses any pickled field: a spilled image loads without unpickling
anything.  bfloat16 leaves travel as their raw 2-byte words (numpy dtype
``V2``, what the ``.npy`` framing reads back for the reference's
bfloat16 too); a restore reinterprets them as the slot's dtype.
"""
from __future__ import annotations

import dataclasses
import io
import pickle
import struct
from typing import Any, BinaryIO, Dict, Iterator

import numpy as np

from repro_torch.tree import leaves

# field tags — one byte each
_T_NONE = b"N"
_T_TRUE = b"T"
_T_FALSE = b"F"
_T_INT = b"i"
_T_FLOAT = b"f"
_T_STR = b"s"
_T_BYTES = b"b"
_T_LIST = b"l"
_T_TUPLE = b"t"
_T_DICT = b"d"
_T_NDARRAY = b"a"
_T_PICKLE = b"p"        # structure-only fallback, never array payloads

_LEN = struct.Struct(">Q")
_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")


# ------------------------------------------------------------ encoding
def _enc(out: io.BytesIO, obj: Any):
    if obj is None:
        out.write(_T_NONE)
    elif obj is True:
        out.write(_T_TRUE)
    elif obj is False:
        out.write(_T_FALSE)
    elif isinstance(obj, (int, np.integer)):
        out.write(_T_INT)
        out.write(_I64.pack(int(obj)))
    elif isinstance(obj, (float, np.floating)):
        out.write(_T_FLOAT)
        out.write(_F64.pack(float(obj)))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.write(_T_STR)
        out.write(_LEN.pack(len(raw)))
        out.write(raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.write(_T_BYTES)
        out.write(_LEN.pack(len(obj)))
        out.write(bytes(obj))
    elif isinstance(obj, np.ndarray):
        if obj.dtype == object:
            raise TypeError("wire: refusing to encode an object-dtype "
                            "array (no bitwise representation)")
        out.write(_T_NDARRAY)
        bio = io.BytesIO()
        # np.ascontiguousarray promotes 0-d to 1-d: copy only when needed
        # so scalar arrays keep their shape across the wire
        arr = obj if obj.flags.c_contiguous else np.ascontiguousarray(obj)
        np.lib.format.write_array(bio, arr, allow_pickle=False)
        raw = bio.getvalue()
        out.write(_LEN.pack(len(raw)))
        out.write(raw)
    elif isinstance(obj, list):
        out.write(_T_LIST)
        out.write(_LEN.pack(len(obj)))
        for x in obj:
            _enc(out, x)
    elif isinstance(obj, tuple):
        out.write(_T_TUPLE)
        out.write(_LEN.pack(len(obj)))
        for x in obj:
            _enc(out, x)
    elif isinstance(obj, dict):
        out.write(_T_DICT)
        out.write(_LEN.pack(len(obj)))
        for k, v in obj.items():
            _enc(out, k)
            _enc(out, v)
    else:
        raw = pickle.dumps(obj, protocol=4)
        out.write(_T_PICKLE)
        out.write(_LEN.pack(len(raw)))
        out.write(raw)


def encode(obj: Any) -> bytes:
    """Serialize ``obj`` (numbers, strings, bytes, lists/tuples/dicts,
    numpy arrays — arrays bitwise via the .npy encoding)."""
    out = io.BytesIO()
    _enc(out, obj)
    return out.getvalue()


# ------------------------------------------------------------ decoding
def _read(buf: io.BytesIO, n: int) -> bytes:
    raw = buf.read(n)
    if len(raw) != n:
        raise EOFError(f"wire: truncated field (wanted {n} bytes, got "
                       f"{len(raw)})")
    return raw


def _dec(buf: io.BytesIO, allow_pickle: bool) -> Any:
    tag = _read(buf, 1)
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return _I64.unpack(_read(buf, 8))[0]
    if tag == _T_FLOAT:
        return _F64.unpack(_read(buf, 8))[0]
    if tag == _T_STR:
        n = _LEN.unpack(_read(buf, 8))[0]
        return _read(buf, n).decode("utf-8")
    if tag == _T_BYTES:
        n = _LEN.unpack(_read(buf, 8))[0]
        return _read(buf, n)
    if tag == _T_NDARRAY:
        n = _LEN.unpack(_read(buf, 8))[0]
        return np.lib.format.read_array(io.BytesIO(_read(buf, n)),
                                        allow_pickle=False)
    if tag == _T_LIST:
        n = _LEN.unpack(_read(buf, 8))[0]
        return [_dec(buf, allow_pickle) for _ in range(n)]
    if tag == _T_TUPLE:
        n = _LEN.unpack(_read(buf, 8))[0]
        return tuple(_dec(buf, allow_pickle) for _ in range(n))
    if tag == _T_DICT:
        n = _LEN.unpack(_read(buf, 8))[0]
        return {_dec(buf, allow_pickle): _dec(buf, allow_pickle)
                for _ in range(n)}
    if tag == _T_PICKLE:
        if not allow_pickle:
            raise ValueError("wire: pickled field where none is allowed")
        n = _LEN.unpack(_read(buf, 8))[0]
        return pickle.loads(_read(buf, n))
    raise ValueError(f"wire: unknown tag {tag!r}")


def decode(raw: bytes, *, allow_pickle: bool = True) -> Any:
    return _dec(io.BytesIO(raw), allow_pickle)


# ------------------------------------------------------------- framing
def write_frame(f: BinaryIO, payload: bytes):
    """Length-prefixed frame: 8 big-endian length bytes + payload."""
    f.write(_LEN.pack(len(payload)))
    f.write(payload)
    f.flush()


def read_frame(f: BinaryIO) -> bytes:
    """Read one frame; raises EOFError on a closed or truncated stream."""
    head = f.read(8)
    if len(head) != 8:
        raise EOFError("wire: stream closed mid-header"
                       if head else "wire: stream closed")
    n = _LEN.unpack(head)[0]
    chunks, got = [], 0
    while got < n:
        chunk = f.read(n - got)
        if not chunk:
            raise EOFError(f"wire: stream closed mid-frame "
                           f"({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


# ------------------------------------------------------ tree structure
def structure(tree) -> Any:
    """The container structure of a cache tree in the codec's own types:
    None for a leaf, ``("dict", keys, children)``, ``("list",
    children)``, ``("tuple", children)`` or ``("namedtuple", name,
    fields, children)``."""
    if isinstance(tree, dict):
        return ("dict", list(tree), [structure(v) for v in tree.values()])
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ("namedtuple", type(tree).__name__, list(tree._fields),
                [structure(v) for v in tree])
    if isinstance(tree, list):
        return ("list", [structure(v) for v in tree])
    if isinstance(tree, tuple):
        return ("tuple", [structure(v) for v in tree])
    return None


def unflatten(struct_, flat) -> Any:
    """Rebuild the tree of ``struct_`` from its leaves in
    ``tree.leaves`` order (a dict's children by sorted key)."""
    it = iter(flat)
    tree = _build(struct_, it)
    if next(it, None) is not None:
        raise ValueError("wire: more leaves than the structure holds")
    return tree


def _build(s, it: Iterator) -> Any:
    if s is None:
        try:
            return next(it)
        except StopIteration:
            raise ValueError("wire: fewer leaves than the structure "
                             "holds") from None
    kind = s[0]
    if kind == "dict":
        keys, kids = s[1], dict(zip(s[1], s[2]))
        built = {k: _build(kids[k], it) for k in sorted(keys)}
        return {k: built[k] for k in keys}
    if kind == "namedtuple":
        from repro_torch.bridge import NAMEDTUPLES
        cls = NAMEDTUPLES.get(s[1])
        if cls is None or list(cls._fields) != list(s[2]):
            raise ValueError(f"wire: no NamedTuple {s[1]}{tuple(s[2])} "
                             f"in this package")
        return cls(*(_build(c, it) for c in s[3]))
    if kind == "list":
        return [_build(c, it) for c in s[1]]
    if kind == "tuple":
        return tuple(_build(c, it) for c in s[1])
    raise ValueError(f"wire: unknown structure node {kind!r}")


# ----------------------------------------------------- SwappedState ⇄ bytes
def encode_swapped(sw) -> bytes:
    """``SwappedState`` -> bytes: the cache tree's structure, its leaves,
    the sampler row and the last token, every array framed bitwise."""
    return encode({
        "structure": structure(sw.caches),
        "leaves": [np.asarray(x) for x in leaves(sw.caches)],
        "sampler": {k: np.asarray(v) for k, v in sw.sampler.items()},
        "token": np.asarray(sw.token),
    })


def decode_swapped(raw: bytes):
    from repro_torch.serving.executor import SwappedState
    d = decode(raw, allow_pickle=False)
    return SwappedState(caches=unflatten(d["structure"], d["leaves"]),
                        sampler=d["sampler"], token=d["token"])


def dump_swapped(path: str, sw):
    """Spool-tier writer: the on-disk spill image is the wire encoding."""
    with open(path, "wb") as f:
        f.write(encode_swapped(sw))


def load_swapped(path: str):
    with open(path, "rb") as f:
        return decode_swapped(f.read())


# ---------------------------------------------------------- Request ⇄ bytes
def encode_request(req) -> bytes:
    """``Request`` -> bytes, field-complete: prompt arrays bitwise,
    wall-clock stamps verbatim (``perf_counter`` is comparable across
    processes on one Linux host)."""
    return encode({f.name: getattr(req, f.name)
                   for f in dataclasses.fields(req)})


def decode_request(raw: bytes):
    from repro_torch.serving.scheduler import Request
    d = decode(raw)
    d["output"] = list(d.get("output") or [])
    return Request(**d)


# ------------------------------------------------------ swap record ⇄ bytes
def encode_swap_record(rec) -> bytes:
    """A scheduler ``_Swapped`` record (request + harvested host image +
    swap stamp) -> bytes.  The record must be fully harvested: no pending
    drain, prefetch or spool file."""
    if rec.pending is not None or rec.prefetch is not None \
            or rec.spool is not None:
        raise ValueError("wire: swap record must be fully harvested "
                         "before it crosses the process boundary")
    return encode({
        "req": encode_request(rec.req),
        "state": (encode_swapped(rec.state)
                  if rec.state is not None else None),
        "t_swap": rec.t_swap,
    })


def decode_swap_record(raw: bytes):
    from repro_torch.serving.scheduler import _Swapped
    d = decode(raw)
    return _Swapped(
        req=decode_request(d["req"]),
        state=(decode_swapped(d["state"])
               if d["state"] is not None else None),
        t_swap=d["t_swap"])


REQUEST_SYNC_FIELDS = (
    "output", "done", "state", "t_submit", "t_first", "t_done",
    "swapped_s", "_swapped_pre_first_s", "t_last_activity", "_t_active",
)


def request_update(req) -> Dict[str, Any]:
    """The mutable-progress slice of a ``Request``."""
    u = {"rid": req.rid}
    for k in REQUEST_SYNC_FIELDS:
        v = getattr(req, k)
        u[k] = list(v) if k == "output" else v
    return u


def apply_request_update(req, u: Dict[str, Any]):
    for k in REQUEST_SYNC_FIELDS:
        v = u[k]
        setattr(req, k, list(v) if k == "output" else v)
