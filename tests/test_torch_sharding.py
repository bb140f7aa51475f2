"""The port's sharding rules (``repro_torch.parallel.sharding``) and mesh
helpers (``repro_torch.launch.mesh``, ``configs.base.ServingTopology``)
against the reference's, on the CPU.

The rule functions of both packages read only a mesh's ``axis_names`` and
``shape[name]``, so a stand-in namespace holds any mesh size without
devices or process groups.  For every arch at the meshes (2,1), (1,2),
(4,2), (1,16) and the (2,16,16) pod mesh, entry for entry by key path:
``params_specs`` (FSDP on and off) of the port's own full-width tree
(built on the meta device) against the reference's on its
``jax.eval_shape`` tree; ``cache_specs`` / ``slot_specs`` /
``checkpoint_specs`` / ``staging_specs`` at a dividing and a non-dividing
slot count; ``sampler_specs``, ``token_slot_spec`` and ``batch_specs``;
``fit_spec``'s drop-and-replace cases; ``estimate_params``,
``needs_fsdp`` and each mixer's ``param_count``.  Then the cut of a
tensor into a rank's shard, ``ServingTopology`` and
``validate_mesh_shape`` (the reference's ``tests/test_serving_mesh.py``
topology and validation cases).
"""
import functools
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                       # noqa: E402
from repro.configs.base import ServingTopology as JTopology  # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.models.mixers import get_mixer as jget_mixer      # noqa: E402
from repro.parallel import sharding as jrules                # noqa: E402
from repro.serving import sampling as jsampling              # noqa: E402
from repro_torch import configs as tconfigs                  # noqa: E402
from repro_torch.configs.base import ServingTopology         # noqa: E402
from repro_torch.launch import mesh as tmesh                 # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.models.mixers import MIXERS                 # noqa: E402
from repro_torch.parallel import sharding as trules          # noqa: E402
from repro_torch.serving import sampling as tsampling        # noqa: E402
from repro_torch.tree import tree_map_with_path              # noqa: E402

ARCHS = sorted(tconfigs.ARCHS)
MESHES = {
    "2x1": (("data", "model"), (2, 1)),
    "1x2": (("data", "model"), (1, 2)),
    "4x2": (("data", "model"), (4, 2)),
    "1x16": (("data", "model"), (1, 16)),
    "pod2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}
MAX_LEN = 4096


def _mesh(name):
    names, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)))


def _entry(e):
    """A spec entry as a comparable value: jax writes a one-axis tuple
    entry as the axis name, so both sides do."""
    if isinstance(e, (list, tuple)):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _entries(spec):
    return tuple(_entry(e) for e in spec)


def _jflat(tree):
    """The reference's spec tree -> {path: entries}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jrules.path_str(p): _entries(s) for p, s in flat}


def _tflat(tree):
    """The port's spec tree -> {path: entries}."""
    out = {}

    def put(path, s):
        out[trules.path_str(path)] = _entries(s)
    tree_map_with_path(put, tree)
    return out


@functools.lru_cache(maxsize=None)
def _params(arch):
    jcfg = jconfigs.get_arch(arch)
    jshape = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0),
                                                jcfg))
    tcfg = tconfigs.get_arch(arch)
    return jcfg, jshape, tcfg, tlm.init_lm(None, tcfg, device="meta")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_params_specs_equal_the_reference(arch, mesh):
    jcfg, jshape, tcfg, tparams = _params(arch)
    m = _mesh(mesh)
    for fsdp in (False, True):
        want = _jflat(jrules.params_specs(jcfg, jshape, fsdp, m))
        got = _tflat(trules.params_specs(tcfg, tparams, fsdp, m))
        assert got == want, (fsdp, {k: (got.get(k), want.get(k))
                                    for k in set(got) | set(want)
                                    if got.get(k) != want.get(k)})


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_slot_and_staging_specs_equal_the_reference(arch, mesh):
    """Dividing and non-dividing slot counts (the non-dividing ones hit
    ``cache_specs``' tiny-batch rule: dk on "data")."""
    jcfg, tcfg = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    m = _mesh(mesh)
    dp = jrules.axis_size(m, jrules.dp_axes(m))
    for slots in sorted({dp, 2 * dp, dp + 1, 3}):
        jc = jax.eval_shape(lambda: jlm.init_caches(jcfg, slots, MAX_LEN))
        tc = tlm.cache_specs(tcfg, slots, MAX_LEN).tree
        tck = tlm.checkpoint_specs(tcfg, slots, MAX_LEN).tree
        want = jrules.cache_specs(jcfg, m, jc, slots)
        assert _tflat(trules.cache_specs(tcfg, m, tc, slots)) == \
            _jflat(want), slots
        slot = trules.slot_specs(tcfg, m, tc, slots)
        assert _tflat(slot) == _jflat(
            jrules.slot_specs(jcfg, m, jc, slots)), slots
        assert _tflat(trules.checkpoint_specs(tcfg, m, tck, slots)) == \
            _jflat(jrules.checkpoint_specs(jcfg, m, jc, slots)), slots
        assert _tflat(trules.staging_specs(slot)) == _jflat(
            jrules.staging_specs(want)), slots


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_serving_and_batch_specs_equal_the_reference(mesh):
    m = _mesh(mesh)
    dp = jrules.axis_size(m, jrules.dp_axes(m))
    for slots in (dp, 2 * dp, dp + 1):
        jsamp = jax.eval_shape(lambda: jsampling.init_state(slots))
        tsamp = tsampling.init_state(slots, "meta")
        assert set(jsamp) == set(tsamp)
        want = jrules.sampler_specs(m, jsamp, slots)
        got = trules.sampler_specs(m, tsamp, slots)
        assert {k: _entries(v) for k, v in got.items()} == \
            {k: _entries(v) for k, v in want.items()}, slots
        assert _entries(trules.token_slot_spec(m, slots)) == \
            _entries(jrules.token_slot_spec(m, slots)), slots
    for batch in (dp, 4 * dp, 3):
        shapes = {"tokens": types.SimpleNamespace(shape=(batch, 128)),
                  "embeds": types.SimpleNamespace(shape=(batch, 128, 64)),
                  "labels": types.SimpleNamespace(shape=(batch, 128))}
        got = trules.batch_specs(m, shapes)
        want = jrules.batch_specs(m, shapes)
        assert {k: _entries(v) for k, v in got.items()} == \
            {k: _entries(v) for k, v in want.items()}, batch


FIT_CASES = [
    # (spec, shape): kept, dropped, dropped and re-placed, multi-axis
    ((None, "model", None), (2048, 16, 128)),
    ((None, "model", None), (2048, 7, 128)),
    (("model", None), (32003, 2048)),
    (("model", "data"), (5, 3)),
    ((("pod", "data"), None), (64, 8)),
    ((("pod", "data"), None), (6, 8)),
    ((None, "data", "model", None, None), (12, 3, 32, 128, 128)),
]


def _names_of(spec):
    return {a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)}


# each case on every mesh that has its axes
FIT_RUNS = [(c, m) for c in range(len(FIT_CASES)) for m in sorted(MESHES)
            if _names_of(FIT_CASES[c][0]) <= set(MESHES[m][0])]


@pytest.mark.parametrize("case,mesh", FIT_RUNS)
def test_fit_spec_equals_the_reference(case, mesh):
    spec, shape = FIT_CASES[case]
    m = _mesh(mesh)
    got = trules.fit_spec(trules.P(*spec), shape, m)
    want = jrules.fit_spec(jax.sharding.PartitionSpec(*spec), shape, m)
    assert _entries(got) == _entries(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_fsdp_equal_the_reference(arch):
    jcfg, tcfg = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    assert trules.estimate_params(tcfg) == jrules.estimate_params(jcfg)
    for kind in sorted(set(tcfg.layer_kinds)):
        assert MIXERS[kind].param_count(tcfg) == \
            jget_mixer(kind).param_count(jcfg), kind
    for mesh in MESHES:
        m = _mesh(mesh)
        for budget in (1.0, 10.0, 80.0):
            assert trules.needs_fsdp(tcfg, m, budget) == \
                jrules.needs_fsdp(jcfg, m, budget), (mesh, budget)


def test_local_shard_and_its_inverse():
    """The cut of a full tensor into each rank's block tiles it, the
    multi-axis entry row-major with the first axis major (as jax's
    device order), and ``gather_shard`` over stand-in axes (whose
    all-gather concatenates every rank's block) restores it."""
    full = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    spec = trules.P(None, ("data", "model"), "pod")
    sizes = {"data": 3, "model": 2, "pod": 2}
    blocks = {}
    for d in range(3):
        for mo in range(2):
            for p in range(2):
                c = {"data": d, "model": mo, "pod": p}
                blocks[d, mo, p] = trules.local_shard(full, spec, c, sizes)
                assert blocks[d, mo, p].shape == \
                    trules.local_shape(full.shape, spec, sizes)
                assert torch.equal(blocks[d, mo, p],
                                   full[:, d * 2 + mo:d * 2 + mo + 1,
                                        p * 4:(p + 1) * 4])

    class Axis:
        def __init__(self, name):
            self.name, self.size = name, sizes[name]
            self.me = None

        def all_gather(self, t, dim):
            # this rank's coordinates with the axis swept over
            c = dict(self.me)
            parts = []
            for i in range(self.size):
                c[self.name] = i
                parts.append(gathered(c, upto=self.name))
            return torch.cat(parts, dim)

    axes = {n: Axis(n) for n in sizes}
    order = ["model", "data", "pod"]       # the order gather_shard sweeps

    def gathered(c, upto):
        # the tensor a rank at c holds once the axes before `upto` are
        # gathered: recompute it from the blocks
        t = blocks[c["data"], c["model"], c["pod"]]
        for name in order[:order.index(upto)]:
            axes[name].me = c
            t = axes[name].all_gather(t, {"model": 1, "data": 1,
                                          "pod": 2}[name])
        return t

    me = {"data": 1, "model": 0, "pod": 1}
    for a in axes.values():
        a.me = me
    assert torch.equal(trules.gather_shard(blocks[1, 0, 1], spec, axes),
                       full)


# -------------------------- the reference's topology / validation cases

def test_topology_parse_and_pad():
    t = ServingTopology.parse("4,2")
    assert t.shape == (4, 2) and t.axes == ("data", "model")
    assert t.devices == 8
    t = ServingTopology.parse("data=2,model=3", staging_depth=3)
    assert (t.data, t.model, t.staging_depth) == (2, 3, 3)
    assert ServingTopology(data=4).pad_slots(5) == 8
    assert ServingTopology(data=4).pad_slots(8) == 8
    assert ServingTopology().pad_slots(3) == 3
    for bad in ("4", "4,2,1", "data=4,oops=2", "0,2", "a,b"):
        with pytest.raises(ValueError):
            ServingTopology.parse(bad)
    for text in ("4,2", "data=2,model=3", "1,1", " 2 , 2 "):
        a, b = ServingTopology.parse(text), JTopology.parse(text)
        assert (a.shape, a.axes, a.devices, a.staging_depth) == \
            (b.shape, b.axes, b.devices, b.staging_depth)
        assert [a.pad_slots(s) for s in range(1, 9)] == \
            [b.pad_slots(s) for s in range(1, 9)]


def test_validate_mesh_shape_up_front():
    """A bad topology fails with a one-line ValueError before any process
    group is touched; the message says how to start the ranks."""
    assert tmesh.validate_mesh_shape((1, 1), ("data", "model")) == (1, 1)
    with pytest.raises(ValueError, match="start 8 ranks") as e:
        tmesh.validate_mesh_shape((4, 2), ("data", "model"),
                                  device_count=1)
    assert "XLA_FLAGS" not in str(e.value)
    with pytest.raises(ValueError, match="positive int"):
        tmesh.validate_mesh_shape((0, 2), ("data", "model"))
    with pytest.raises(ValueError, match="positive int"):
        tmesh.validate_mesh_shape((True, 2), ("data", "model"))
    with pytest.raises(ValueError, match="axes"):
        tmesh.validate_mesh_shape((2, 2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="duplicate"):
        tmesh.validate_mesh_shape((2, 2), ("data", "data"),
                                  device_count=4)
    # one process without a process group is one device
    with pytest.raises(ValueError, match="needs 4 devices"):
        tmesh.make_serving_mesh(2, 2)
    with pytest.raises(ValueError, match="needs 256 devices"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 devices"):
        tmesh.make_production_mesh(multi_pod=True)


def test_a_pod_mesh_shards_slots_over_pod_and_data():
    """``dp_axes`` is ("pod", "data") on a pod mesh: the slot axis of the
    port's cache tree takes both, major first."""
    m = _mesh("pod2x16x16")
    tcfg = tconfigs.get_arch("qwen3-next-gdn")
    specs = _tflat(trules.slot_specs(
        tcfg, m, tlm.cache_specs(tcfg, 64, MAX_LEN).tree, 64))
    assert specs["0/0/S"] == (None, ("pod", "data"), "model", None, None)
    assert specs["0/3/k"] == (None, ("pod", "data"), None, "model", None)
    assert np.prod([m.shape[a] for a in ("pod", "data")]) == 32
