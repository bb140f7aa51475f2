"""The port's configs, its numpy bridge and its import isolation.

``ArchConfig`` must convert one to one (``dataclasses.asdict`` equality,
full and ``reduced()``), the bridge must round-trip the reference's trees
bitwise, and importing every module of ``repro_torch`` must leave ``jax``
and ``repro`` unimported (checked in a fresh interpreter).
"""
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                    # noqa: E402
from repro.models import lm as jlm                        # noqa: E402
from repro.optim import optimizers as jopt                # noqa: E402
from repro.serving import sampling as jsampling           # noqa: E402
from repro_torch import configs as tconfigs               # noqa: E402
from repro_torch.bridge import to_numpy, to_torch         # noqa: E402
from repro_torch.models import attention, gdn_layer       # noqa: E402
from repro_torch.models import lm as tlm                  # noqa: E402
from repro_torch.tree import leaves                       # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_reference(reduced):
    assert set(tconfigs.ARCHS) <= set(jconfigs.ARCHS)
    for name in tconfigs.ARCHS:
        j, t = jconfigs.get_arch(name), tconfigs.get_arch(name)
        if reduced:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.layer_kinds == j.layer_kinds
        assert (t.hq_eff, t.hkv_eff) == (j.hq_eff, j.hkv_eff)
        if j.n_heads:            # attention-free mamba2 has no head mask
            np.testing.assert_array_equal(t.head_mask(), j.head_mask())
        assert t.uses_attention == j.uses_attention
        assert t.pure_full_attention == j.pure_full_attention
        assert tlm.build_groups(t) == jlm.build_groups(j)


def test_unported_arch_names_its_roadmap_item():
    """An unknown arch's KeyError lists the port's registry."""
    with pytest.raises(KeyError, match="the port has .*'arctic-480b'.*"
                                       "'mixtral-8x7b'"):
        tconfigs.get_arch("mixtral-8x22b")


def test_registries_hold_the_reference_kinds():
    """Every mixer kind and every arch of the reference's registries is
    ported."""
    from repro.models.mixers import MIXERS as JMIXERS
    from repro_torch.models.mixers import MIXERS
    assert sorted(MIXERS) == sorted(JMIXERS) == \
        ["attn", "gdn", "gdn_naive", "rglru", "ssm", "swa"]
    assert set(tconfigs.ARCHS) == set(jconfigs.ARCHS)


def test_cache_specs_match_reference():
    for arch in ("qwen3-next-gdn", "mamba2-1.3b", "recurrentgemma-2b"):
        for act in ("float32", "bfloat16"):
            j = jconfigs.get_arch(arch).replace(act_dtype=act)
            t = tconfigs.get_arch(arch).replace(act_dtype=act)
            js, ts = jlm.cache_specs(j, 4, 1024), tlm.cache_specs(t, 4, 1024)
            assert (ts.state_bytes, ts.window_bytes, ts.nbytes) == \
                (js.state_bytes, js.window_bytes, js.nbytes), arch
            assert [l.shape for l in ts.leaves()] == \
                [tuple(l.shape) for l in js.leaves()], arch
            assert [l.role for l in ts.leaves()] == \
                [l.role for l in js.leaves()], arch


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_bridge_round_trip_is_bitwise(act):
    cfg = jconfigs.get_arch("qwen3-next-gdn").reduced().replace(
        act_dtype=act)
    params = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(1),
                                                    cfg)
    caches = jlm.init_caches(cfg, 2, 16)
    caches = jax.tree.map(lambda a: a + jnp.ones_like(a), caches)
    sampler = jsampling.admit_slot(jsampling.init_state(2), 1, seed=5,
                                   rid=77, temperature=0.5, top_k=3,
                                   top_p=0.9, eos_id=4, budget=8)
    # the training state: moments in the activation dtype (bf16 adds the
    # error-feedback buffer), nonzero, and the int32 count and step
    adamw = jopt.AdamWConfig(moment_dtype=act)
    train_state = jax.tree.map(lambda a: a + jnp.ones_like(a), {
        "params": params, "opt": jopt.init_adamw(params, adamw),
        "step": jnp.zeros((), jnp.int32)})
    for tree in (params, caches, sampler, train_state):
        np_tree = jax.tree.map(np.asarray, tree)
        back = to_numpy(to_torch(np_tree))
        a = jax.tree.leaves(np_tree)
        b = leaves(back)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == y.shape
            if x.dtype == np.uint32:              # keys ride in int64
                assert y.dtype == np.int64
                y = y.astype(np.uint32)
            assert x.dtype == y.dtype
            assert x.tobytes() == y.tobytes()
    t_caches = to_torch(jax.tree.map(np.asarray, caches))
    assert isinstance(t_caches[0][0], gdn_layer.GDNState)
    assert isinstance(t_caches[0][3], attention.KVCache)
    assert t_caches[0][3].length.dtype == torch.int32


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_bridge_round_trip_new_states_is_bitwise(arch):
    """The reference's SSMState / RGLRUState caches (and params) cross
    over bitwise, in bf16 and as the port's own NamedTuples."""
    cfg = jconfigs.get_arch(arch).reduced().replace(act_dtype="bfloat16")
    params = jax.jit(jlm.init_lm, static_argnums=1)(jax.random.PRNGKey(2),
                                                    cfg)
    caches = jax.tree.map(lambda a: a + jnp.ones_like(a),
                          jlm.init_caches(cfg, 2, 16))
    for tree in (params, caches):
        np_tree = jax.tree.map(np.asarray, tree)
        a, b = jax.tree.leaves(np_tree), leaves(to_numpy(to_torch(np_tree)))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
    t_caches = to_torch(jax.tree.map(np.asarray, caches))
    name = "SSMState" if arch == "mamba2-1.3b" else "RGLRUState"
    assert type(t_caches[0][0]).__name__ == name
    assert type(t_caches[0][0]).__module__.startswith("repro_torch.")


def test_import_leaves_jax_and_repro_out():
    """Every module of the port, imported in a fresh interpreter."""
    mods = sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts)
        .replace(".__init__", "")
        for p in (SRC / "repro_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n")
    assert {"repro_torch.optim.optimizers", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.manager", "repro_torch.runtime.trainer",
            "repro_torch.launch.train",
            "repro_torch.kernels.flash_attn", "repro_torch.models.ssm",
            "repro_torch.models.rglru", "repro_torch.models.mixers.ssm",
            "repro_torch.models.mixers.rglru",
            "repro_torch.models.mixers.gdn_naive",
            "repro_torch.serving.router",
            "repro_torch.serving.rpc"} <= set(mods)
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(mods) >= 20


def test_train_cli_needs_a_card_or_cpu(monkeypatch, capsys):
    """Without a card the train CLI raises unless given --device cpu."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--arch", "qwen3-next-gdn", "--steps", "2", "--global-batch",
            "2", "--seq-len", "16"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(args)
    hist = train.main(args + ["--device", "cpu", "--kernels"])
    assert [s for s, _ in hist] == [2]
    assert "step      2 loss" in capsys.readouterr().out
