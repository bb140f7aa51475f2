"""The port's decode intensity model (``repro_torch.core.intensity``, the
mixers' ``decode_flops`` / ``decode_token_bytes``) against the live
reference's (``repro.core.intensity``), on the CPU: every registered
arch and each of its layer kinds, exact equality.  Then the paper's
Table II and Fig. 1 numbers with the reference's own asserts
(``tests/test_core_gdn.py``)."""
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs                       # noqa: E402
from repro.core import intensity as jint                    # noqa: E402
from repro.models.mixers import get_mixer as jget_mixer     # noqa: E402
from repro_torch import configs as tconfigs                 # noqa: E402
from repro_torch.core import intensity as tint              # noqa: E402
from repro_torch.models.mixers import MIXERS                # noqa: E402
from repro_torch.models.mixers import get_mixer as tget_mixer  # noqa: E402

ARCHS = sorted(tconfigs.ARCHS)
SEQ = 4096
ARCH_KINDS = [(a, k) for a in ARCHS
              for k in sorted(set(tconfigs.get_arch(a).layer_kinds))]


def _profile(p):
    return (p.name, p.flops, p.state_bytes, p.token_bytes, p.total_bytes,
            p.intensity)


def test_archs_match_the_reference():
    assert ARCHS == sorted(jconfigs.ARCHS)
    assert sorted(MIXERS) == sorted(
        {k for a in ARCHS for k in jconfigs.get_arch(a).layer_kinds}
        | {"gdn_naive"})


@pytest.mark.parametrize("arch,kind", ARCH_KINDS)
def test_mixer_decode_model(arch, kind):
    tcfg, jcfg = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
    tm, jm = tget_mixer(kind), jget_mixer(kind)
    for seq in (1, 1000, SEQ, 524288):
        assert tm.decode_flops(tcfg, seq) == jm.decode_flops(jcfg, seq)
    assert tm.decode_token_bytes(tcfg) == jm.decode_token_bytes(jcfg)
    assert tm.state_passes == jm.state_passes
    assert tint.mixer_state_bytes(tcfg, kind) == \
        jint.mixer_state_bytes(jcfg, kind)
    assert tint.mixer_checkpoint_bytes(tcfg, kind, max_len=SEQ) == \
        jint.mixer_checkpoint_bytes(jcfg, kind, max_len=SEQ)
    for persistent in (False, True):
        assert _profile(tint.mixer_decode_profile(
            tcfg, kind, seq=SEQ, persistent=persistent)) == _profile(
            jint.mixer_decode_profile(jcfg, kind, seq=SEQ,
                                      persistent=persistent))


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_profiles(arch):
    tcfg, jcfg = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
    assert tint.arch_state_bytes(tcfg) == jint.arch_state_bytes(jcfg)
    for persistent in (False, True):
        assert _profile(tint.arch_decode_profile(
            tcfg, seq=SEQ, persistent=persistent)) == _profile(
            jint.arch_decode_profile(jcfg, seq=SEQ, persistent=persistent))
    assert tint.arch_checkpoint_bytes(tcfg, max_len=SEQ) == \
        jint.arch_checkpoint_bytes(jcfg, max_len=SEQ)
    for k_draft, acc in ((0, 0.0), (4, 0.75), (2, 1.0)):
        assert _profile(tint.speculative_decode_profile(
            tcfg, k_draft=k_draft, acceptance=acc, seq=SEQ)) == _profile(
            jint.speculative_decode_profile(jcfg, k_draft=k_draft,
                                            acceptance=acc, seq=SEQ))
    # a draft of another arch (the qwen3-next-gdn target's own family)
    tq, jq = (tconfigs.get_arch("qwen3-next-gdn"),
              jconfigs.get_arch("qwen3-next-gdn"))
    assert _profile(tint.speculative_decode_profile(
        tq, k_draft=3, acceptance=0.5, draft_cfg=tcfg)) == _profile(
        jint.speculative_decode_profile(jq, k_draft=3, acceptance=0.5,
                                        draft_cfg=jcfg))


def test_speculative_profile_errors():
    cfg = tconfigs.get_arch("qwen3-next-gdn")
    for kw, msg in (({"k_draft": 2, "acceptance": 1.5}, "acceptance"),
                    ({"k_draft": -1, "acceptance": 0.5}, "k_draft")):
        with pytest.raises(ValueError, match=msg):
            tint.speculative_decode_profile(cfg, **kw)


def test_base_mixer_raises():
    from repro_torch.models.mixers.base import SequenceMixer
    with pytest.raises(NotImplementedError):
        SequenceMixer.decode_flops(tconfigs.get_arch("yi-9b"), 1)
    with pytest.raises(NotImplementedError):
        SequenceMixer.decode_token_bytes(tconfigs.get_arch("yi-9b"))


def test_family_profiles_match_the_reference():
    for kw in ({}, {"persistent": True}, {"fused": False},
               {"h_v": 16, "d": 64, "w": 2}):
        assert _profile(tint.gdn_profile(**kw)) == \
            _profile(jint.gdn_profile(**kw))
    for kw in ({}, {"seq": 32768, "h_kv": 1}):
        assert _profile(tint.gqa_profile(**kw)) == \
            _profile(jint.gqa_profile(**kw))
    for kw in ({}, {"persistent": True}):
        assert _profile(tint.mamba2_profile(**kw)) == \
            _profile(jint.mamba2_profile(**kw))
        assert _profile(tint.rglru_profile(**kw)) == \
            _profile(jint.rglru_profile(**kw))


def test_paper_table2_numbers():
    t2 = tint.paper_table2()
    assert t2 == jint.paper_table2()
    # the reference's asserts (tests/test_core_gdn.py)
    assert 3.5e6 < t2["gpu"]["flops"] < 5e6
    assert t2["gpu"]["intensity"] < 1.1         # memory-bound on GPU
    assert t2["ours"]["intensity"] > 50          # compute-bound on-chip
    assert t2["ours"]["state_bytes"] == 0.0


def test_fig1_ordering():
    f = tint.fig1_intensities()
    assert f == jint.fig1_intensities()
    assert f["gdn"] < f["mhsa_gqa"] * 1.5
    assert f["mamba2"] < 1.0
    assert f["gdn"] < 1.0
    assert f["gdn_ours_persistent"] > 50


def test_core_exports():
    import repro_torch.core as tcore
    assert tcore.intensity is tint
    assert {"gdn", "intensity", "gdn_decode", "gdn_prefill"} <= \
        set(tcore.__all__)
