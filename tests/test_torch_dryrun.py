"""The port's dry run (``repro_torch.launch.steps``, ``launch.op_cost``,
``launch.dryrun``, ``parallel.comm.DryAxis``) against the live reference's
(``repro.launch.steps``, ``repro.launch.hlo_cost``), on the CPU.  Every
step runs on the meta device: nothing is materialised at full width.

  * ``SHAPES`` / ``shape_applicable``, ``adamw_config_for``,
    ``microbatches_for`` (stand-in meshes (1,1), (16,16), (2,16,16)),
    ``input_specs`` (shapes and dtypes of every applicable cell against
    the reference's ``ShapeDtypeStruct``s) and ``model_flops``: equal;
  * the counter's unit cases: a matmul, a batched matmul, an einsum,
    views costing no bytes, a dry axis's all-gather and all-reduce;
  * a reduced fp32 qwen3-next-gdn's decode, prefill and train cells at
    one device: the port's FLOPs within ``FLOPS_RTOL`` of the reference's
    ``hlo_cost`` count of the compiled cell.  The gaps, by op: the GDN
    decode's per-head q.k is a dot in the reference and a multiply-sum in
    the port (``core.gdn.decode_step_fused``: the port 0.11% below), and
    the backward of the GDN chunk's triangular solve (torch's autograd
    formula of ``linalg.solve_triangular`` vs jax's transpose rule: the
    port 0.15% above); the prefill's products are equal;
  * the collectives of one full-width decode step at B 4 on a dry (1,2)
    mesh: the counts the card's runs took on gloo ranks (minicpm-2b's
    with its table and tied logits on d_model: phase 19 (a));
  * every arch's decode_32k cell at (16,16) is counted: none is refused
    since the model code follows ``fit_spec``'s moves (minicpm-2b,
    mamba2-1.3b, mixtral-8x7b and arctic-480b were refused before).
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                   # noqa: E402
from repro import configs as jconfigs                       # noqa: E402
from repro.configs import base as jbase                     # noqa: E402
from repro.launch import hlo_cost                           # noqa: E402
from repro.launch import steps as jsteps                    # noqa: E402
from repro_torch import configs as tconfigs                 # noqa: E402
from repro_torch.configs import base as tbase               # noqa: E402
from repro_torch.launch import dryrun as tdryrun            # noqa: E402
from repro_torch.launch import op_cost                      # noqa: E402
from repro_torch.launch import steps as tsteps              # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.parallel import comm                       # noqa: E402
from repro_torch.parallel import sharding as tsharding      # noqa: E402
from repro_torch.tree import leaves                         # noqa: E402

ARCHS = sorted(tconfigs.ARCHS)
MESHES = {"1x1": {"data": 1, "model": 1},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
FLOPS_RTOL = 5e-3
# collectives per decode step at (1,2), B 4 (PERF.md section 2, the card's
# phase 13 (c) and phase 14 (b)-(d) counts on gloo ranks)
COLLECTIVES_1x2 = {"qwen3-next-gdn": 134, "mamba2-1.3b": 146,
                   "recurrentgemma-2b": 96, "mixtral-8x7b": 82,
                   "minicpm-2b": 202}
# the archs whose (16,16) cells the model axis's moves reach (refused
# before the model code followed them)
MOVED_16 = {"minicpm-2b", "mamba2-1.3b", "mixtral-8x7b", "arctic-480b"}


def _mesh(sizes):
    return types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))


def _reference_model_flops():
    """``repro.launch.dryrun.model_flops``: the module sets XLA_FLAGS on
    import, which must not leak into later subprocesses of this worker."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun.model_flops


# ------------------------------------------------------------------ steps

def test_shapes_and_applicability():
    assert tbase.SHAPES.keys() == jbase.SHAPES.keys()
    for name, shape in tbase.SHAPES.items():
        j = jbase.SHAPES[name]
        assert (shape.name, shape.seq_len, shape.global_batch,
                shape.kind) == (j.name, j.seq_len, j.global_batch, j.kind)
    skips = set()
    for arch in ARCHS:
        for name in tbase.SHAPES:
            got = tbase.shape_applicable(tconfigs.get_arch(arch), name)
            assert got == jbase.shape_applicable(jconfigs.get_arch(arch),
                                                 name)
            if not got[0]:
                skips.add((arch, name))
    assert skips == {(a, "long_500k") for a in (
        "llava-next-34b", "minicpm-2b", "minitron-8b", "yi-9b",
        "musicgen-medium", "arctic-480b")}


@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_and_microbatch_policy(arch):
    tcfg, jcfg = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
    assert tuple(tsteps.adamw_config_for(tcfg)) == \
        tuple(jsteps.adamw_config_for(jcfg))
    for sizes in MESHES.values():
        mesh = _mesh(sizes)
        for shape in tbase.SHAPES.values():
            assert tsteps.microbatches_for(tcfg, shape, mesh) == \
                jsteps.microbatches_for(jcfg, jbase.SHAPES[shape.name], mesh)


def test_input_specs_and_model_flops():
    jflops = _reference_model_flops()
    for arch in ARCHS:
        tcfg, jcfg = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
        for name, shape in tbase.SHAPES.items():
            assert tdryrun.model_flops(tcfg, shape) == \
                jflops(jcfg, jbase.SHAPES[name])
            if not tbase.shape_applicable(tcfg, name)[0]:
                continue
            mine = tsteps.input_specs(tcfg, shape)
            ref = jsteps.input_specs(jcfg, jbase.SHAPES[name])
            assert sorted(mine) == sorted(ref), (arch, name)
            for key in mine:
                got = [(tuple(t.shape), str(t.dtype).split(".")[-1])
                       for t in leaves(mine[key])]
                want = [(tuple(s.shape), str(s.dtype))
                        for s in jax.tree.leaves(ref[key])]
                assert got == want, (arch, name, key)
                assert all(t.device.type == "meta"
                           for t in leaves(mine[key]))


# ------------------------------------------------------------------ counter

def test_counter_matmuls_and_views():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with op_cost.OpCounter() as c:
        a @ b
    assert c.flops == 2 * 8 * 4 * 16
    assert c.bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4
    x, y = torch.randn(3, 8, 16), torch.randn(3, 16, 4)
    with op_cost.OpCounter() as c:
        torch.bmm(x, y)
    assert c.flops == 2 * 3 * 8 * 4 * 16
    with op_cost.OpCounter() as c:
        torch.einsum("bij,bjk->bik", x, y)
    assert c.flops == 2 * 3 * 8 * 4 * 16
    assert c.bytes == (3 * 8 * 16 + 3 * 16 * 4 + 3 * 8 * 4) * 4
    with op_cost.OpCounter() as c:
        x.view(3, 128)
        x.transpose(1, 2)
        x.reshape(24, 16)
        x[1:, :4].unsqueeze(0).expand(2, 2, 4, 16)
        torch.empty(100)
    assert c.flops == 0 and c.bytes == 0 and c.ops > 0


def test_counter_live_bytes():
    x = torch.empty(1000, device="meta")
    with op_cost.OpCounter() as c:
        c.start([x])
        y = x * 2                      # +4000
        z = y + 1                      # +4000
        del y                          # -4000
        w = z.exp()                    # +4000
    assert c.peak_bytes == 12000 and c.live == 12000
    assert w.shape == z.shape


def test_dry_axis_collectives():
    with op_cost.OpCounter() as c:
        axes = comm.DryMeshAxes({"data": 2, "model": 4}, c.record)
        g = axes.model.all_gather(torch.zeros(2, 3), 1)
        r = axes.model.all_reduce(torch.zeros(5))
        d = axes.data.all_reduce(torch.zeros(6, dtype=torch.bfloat16),
                                 mean=True)
        assert axes.data.broadcast(torch.ones(3), 0).shape == (3,)
        m = axes.data.mean_flat([torch.ones(4, 2), torch.ones(3)],
                                [(0,), ()])
    assert g.shape == (2, 12) and r.shape == (5,) and d.dtype == torch.bfloat16
    assert [t.shape for t in m] == [(2, 2), (3,)]
    assert c.collectives == {"all-gather": 24.0, "all-reduce": 20 + 12 + 12,
                             "broadcast": 12.0, "reduce-scatter": 32.0}
    assert c.by_axis == {"model": 20 + 24.0, "data": 12 + 12 + 12 + 32.0}
    assert c.collective_calls == 6
    before = dict(comm.stats)
    alone = comm.DryMeshAxes({"data": 1, "model": 1}, c.record)
    alone.model.all_reduce(torch.ones(2))
    assert c.collective_calls == 6
    assert comm.stats == before         # a dry axis never counts there


# ------------------------------------------------------------------ counts

@pytest.fixture(scope="module")
def jmesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_flops_match_hlo_cost(kind, jmesh):
    """A reduced fp32 qwen3-next-gdn cell at one device: the port's
    counted FLOPs against the reference's ``hlo_cost`` of its compiled
    cell, within ``FLOPS_RTOL`` (the gaps are named in the module
    docstring)."""
    jcfg = jconfigs.get_arch("qwen3-next-gdn").reduced()
    tcfg = tconfigs.get_arch("qwen3-next-gdn").reduced()
    jshape = jbase.ShapeConfig(kind, 64, 2, kind)
    tshape = tbase.ShapeConfig(kind, 64, 2, kind)
    ref = hlo_cost.analyze(
        jsteps.lower_cell(jcfg, jshape, jmesh).compile().as_text())
    mine = tsteps.count_cell(tcfg, tshape, None)
    assert mine["flops"] == pytest.approx(ref["flops"], rel=FLOPS_RTOL)
    assert mine["collectives"] == {"total": 0}
    assert mine["bytes"] > 0
    args = mine["argument_bytes"]
    assert args["params"] == op_cost.tree_bytes(
        tlm.init_lm(None, tcfg, device="meta"))
    assert mine["peak_bytes"] >= args["total"]


@pytest.mark.parametrize("arch", sorted(COLLECTIVES_1x2))
def test_decode_collectives_on_dry_mesh(arch):
    cfg = tconfigs.get_arch(arch)
    if arch == "mixtral-8x7b":
        cfg = cfg.replace(n_layers=16)
    got = tsteps.count_cell(cfg, tbase.ShapeConfig("d", 1024, 4, "decode"),
                            _mesh({"data": 1, "model": 2}))
    assert got["collective_calls"] == COLLECTIVES_1x2[arch]
    assert set(got["collectives_by_axis"]) == {"model"}


def test_decode_cells_at_16x16():
    moved = set()
    for arch in ARCHS:
        res = tdryrun.run_cell(arch, "decode_32k", False)
        assert res["status"] == "ok", res
        dims = tsharding.model_dims(tconfigs.get_arch(arch),
                                    MESHES["16x16"])
        if dims.get("embed") != "vocab" or dims.get("logits") != "vocab" \
                or dims.get("moe_in", "experts") != "experts" \
                or dims.get("attn_q", "heads") != "heads":
            moved.add(arch)
        assert res["flops_per_device"] > 0
        assert res["memory"]["peak_bytes"] >= \
            res["memory"]["argument_bytes"]["total"]
        assert res["roofline"]["dominant"] == "memory_s"
        assert 0 < res["memory_floor_s"] < res["roofline"]["memory_s"]
        assert res["fits_hbm_80g"]
    assert moved == MOVED_16
