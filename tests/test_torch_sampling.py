"""The port's sampler against ``repro.serving.sampling``.

Threefry keys and the uniform bits under them are compared bitwise against
``jax.random`` (partitionable threefry, jax's default); Gumbel noise is
``-log(-log(u))`` of those bits and may differ by the last ulp of the two
libraries' ``log`` (rtol 1e-6).  ``filter_logits`` runs on identical
logits, over the edge cases of ``tests/test_sampling.py``: the supports must
be identical and the kept scaled log-probs agree to 1e-5 (one fp32
log-softmax each).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import sampling as js                  # noqa: E402
from repro_torch.bridge import to_numpy, to_torch         # noqa: E402
from repro_torch.serving import sampling as ts            # noqa: E402


def _logits(seed, s=5, v=64):
    return np.random.default_rng(seed).normal(size=(s, v)).astype(
        np.float32) * 3.0


def _key_np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed,rid", [(0, 3), (0, 0), (7, 123456),
                                      (2**31 - 1, 2**31 - 1)])
def test_fold_in_and_split_are_bitwise(seed, rid):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), rid)
    tk = ts.fold_in(ts.prng_key(seed), rid)
    np.testing.assert_array_equal(tk.numpy(), _key_np(jk))
    for _ in range(3):              # a chain of per-token splits
        jk, jsub = jax.random.split(jk)
        tk, tsub = ts.split(tk)
        np.testing.assert_array_equal(tk.numpy(), _key_np(jk))
        np.testing.assert_array_equal(tsub.numpy(), _key_np(jsub))


def test_fold_in_known_value():
    """jax 0.9, partitionable threefry: fold_in(PRNGKey(0), 3)."""
    assert ts.fold_in(ts.prng_key(0), 3).tolist() == [2467461003,
                                                      3840466878]


def test_uniform_bits_and_gumbel():
    keys = [jax.random.fold_in(jax.random.PRNGKey(1), r) for r in range(4)]
    jkeys = jnp.stack(keys)
    tkeys = torch.from_numpy(_key_np(jkeys))
    n = 1000
    ju = jax.vmap(lambda k: jax.random.uniform(k, (n,)))(jkeys)
    np.testing.assert_array_equal(ts.uniform(tkeys, n).numpy(),
                                  np.asarray(ju))
    jb = jax.vmap(lambda k: jax.random.bits(k, (n,)))(jkeys)
    np.testing.assert_array_equal(ts.random_bits(tkeys, n).numpy(),
                                  np.asarray(jb).astype(np.int64))
    jg = jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(jkeys)
    np.testing.assert_allclose(ts.gumbel(tkeys, n).numpy(), np.asarray(jg),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 8, 1.0), (1.3, 0, 0.9), (0.9, 12, 0.8),
    (2.0, 1, 1.0),
    (1.0, 64, 1.0), (1.0, 640, 1.0),          # top_k >= vocab: identity
    (1e-3, 0, 1.0),                           # temperature -> 0
])
def test_filter_logits_matches_reference(temperature, top_k, top_p):
    logits = _logits(0)
    s = logits.shape[0]
    jf = np.asarray(js.filter_logits(
        jnp.asarray(logits), jnp.full((s,), temperature, jnp.float32),
        jnp.full((s,), top_k, jnp.int32), jnp.full((s,), top_p,
                                                   jnp.float32)))
    tf = ts.filter_logits(torch.from_numpy(logits),
                          torch.full((s,), temperature),
                          torch.full((s,), top_k, dtype=torch.int32),
                          torch.full((s,), top_p)).numpy()
    np.testing.assert_array_equal(np.isfinite(tf), np.isfinite(jf))
    keep = np.isfinite(jf)
    tol = 1e-5 * max(1.0, 1.0 / temperature)
    np.testing.assert_allclose(tf[keep], jf[keep], rtol=1e-5, atol=tol)
    for row in range(s):
        ref = ts.filter_logits_np(logits[row], temperature, top_k, top_p)
        np.testing.assert_array_equal(np.isfinite(ref), np.isfinite(tf[row]))


@pytest.mark.parametrize("top_k,top_p", [(4, 1.0), (8, 1.0), (0, 0.5),
                                         (4, 0.6)])
def test_filter_logits_tied_cutoffs(top_k, top_p):
    base = np.zeros((1, 16), np.float32)
    base[0, :8] = 2.0
    jf = np.asarray(js.filter_logits(
        jnp.asarray(base), jnp.ones((1,)), jnp.full((1,), top_k, jnp.int32),
        jnp.full((1,), top_p)))
    tf = ts.filter_logits(torch.from_numpy(base), torch.ones(1),
                          torch.full((1,), top_k, dtype=torch.int32),
                          torch.full((1,), top_p)).numpy()
    np.testing.assert_array_equal(np.isfinite(tf), np.isfinite(jf))


def _states(temps, top_k, top_p, remaining, eos, done):
    s = len(temps)
    jst = js.init_state(s)
    for i in range(s):
        jst = js.admit_slot(jst, i, seed=3, rid=10 + i,
                            temperature=temps[i], top_k=top_k[i],
                            top_p=top_p[i], eos_id=eos[i],
                            budget=remaining[i])
    jst["done"] = jnp.asarray(done)
    tst = to_torch(jax.tree.map(np.asarray, jst))
    return jst, tst


def test_sample_streams_bitwise():
    """Greedy, temperature, top-k and top-p rows sampled for 6 steps:
    identical tokens and identical advanced states (keys, budgets, done)."""
    logits = _logits(1, s=5, v=256)
    jst, tst = _states([0.0, 1.0, 0.8, 1.2, 0.7], [0, 0, 40, 0, 5],
                       [1.0, 1.0, 1.0, 0.9, 0.95], [6, 6, 3, 6, 6],
                       [None, None, None, None, 17],
                       [False, False, False, False, True])
    j_sample = jax.jit(js.sample)
    for step in range(6):
        lg = logits + step
        jt, jst = j_sample(jst, jnp.asarray(lg))
        tt, tst = ts.sample(tst, torch.from_numpy(lg))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jn = jax.tree.map(np.asarray, jst)
        tn = to_numpy(tst)
        jn["key"] = jn["key"].astype(np.int64)     # the port's key dtype
        for k in jn:
            np.testing.assert_array_equal(tn[k], jn[k], err_msg=k)


def test_sample_skips_pipeline_only_when_no_row_draws():
    """``stochastic=False`` (the host's knowledge that no live row draws)
    gives the tokens and state of the full pipeline for greedy rows."""
    logits = torch.from_numpy(_logits(2))
    _, st = _states([0.0] * 5, [0] * 5, [1.0] * 5, [4] * 5, [None] * 5,
                    [False] * 5)
    t1, s1 = ts.sample(st, logits, stochastic=False)
    t2, s2 = ts.sample(st, logits, stochastic=True)
    assert torch.equal(t1, t2)
    for k in s1:
        assert torch.equal(s1[k], s2[k])
    np.testing.assert_array_equal(t1.numpy(), logits.numpy().argmax(-1))


def test_done_flags_eos_and_budget():
    logits = np.full((3, 16), -5.0, np.float32)
    logits[:, 7] = 5.0
    st = ts.init_state(3)
    st["done"] = torch.tensor([False, False, True])
    st["remaining"] = torch.tensor([5, 1, 5], dtype=torch.int32)
    st["eos_id"] = torch.tensor([7, -1, -1], dtype=torch.int32)
    _, st2 = ts.sample(st, torch.from_numpy(logits))
    assert st2["done"].tolist() == [True, True, True]
    assert int(st2["remaining"][2]) == 5
    st3 = ts.admit_slot(st2, 2, seed=0, rid=9, temperature=0.0, top_k=0,
                        top_p=1.0, eos_id=None, budget=4)
    assert not bool(st3["done"][2]) and int(st3["remaining"][2]) == 4


def test_numpy_mirror_is_the_reference_mirror():
    logits = _logits(3)[0]
    for t, k, p in ((1.0, 0, 1.0), (0.9, 12, 0.8)):
        np.testing.assert_array_equal(
            ts.filter_logits_np(logits, t, k, p),
            js.filter_logits_np(logits, t, k, p))
    assert ts.sample_np(np.random.default_rng(0), logits, temperature=0.7) \
        == js.sample_np(np.random.default_rng(0), logits, temperature=0.7)
