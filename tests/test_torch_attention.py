"""The port's attention and shared layers (``repro_torch.models.attention``,
``models.layers``) against the JAX package, on the CPU, with the same inputs
made from a numpy seed.

Tolerances (float32): rtol = atol = 1e-5 for attention outputs and the
layers: both packages compute the same float32 expressions, but their
matrix products and softmax sums run in different orders (a few ulps).
``blockwise_mha`` against ``mha``: rtol = atol = 1e-5 (the running max and
sum reassociate the softmax).  ``cache_write`` and the masks are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jx_get_smoke  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import layers as jlay  # noqa: E402
from repro.models.params import init_params as jx_init_params  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import layers as lay  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

RTOL = ATOL = 1e-5
B, D = 2, 64

# one compiled program a case (eager jnp compiles each op alone)
jx_attention = jax.jit(jatt.attention, static_argnames=("cfg", "causal", "window", "use_rope"))
jx_mha = jax.jit(jatt.mha, static_argnames=("grouped",))
jx_blockwise = jax.jit(jatt.blockwise_mha, static_argnames=("causal", "window", "block"))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(jnp.asarray(ref, jnp.float32)), rtol=rtol, atol=atol)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _attn_params(kvh, qkv_bias=False, qk_norm=True, heads=4, hd=16, seed=0):
    decls = jatt.attn_decls(D, heads, kvh, hd, qkv_bias=qkv_bias, qk_norm=qk_norm)
    jp = jx_init_params(jax.random.PRNGKey(seed), decls)
    if qkv_bias:  # zeros at init: give the bias terms something to add
        rng = np.random.default_rng(seed)
        jp = {**jp, **{k: jnp.asarray(rng.normal(size=jp[k].shape).astype(np.float32))
                       for k in ("bq", "bk", "bv")}}
    return jp, params_from_reference(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _cfgs(kvh, heads=4, hd=16):
    kw = dict(num_heads=heads, num_kv_heads=kvh, head_dim=hd, d_model=D)
    return jx_get_smoke("qwen3-1.7b").replace(**kw), get_smoke("qwen3-1.7b").replace(**kw)


def _positions(S, start=0):
    pos = np.broadcast_to(np.arange(start, start + S, dtype=np.int32)[None], (B, S)).copy()
    return jnp.asarray(pos), torch.from_numpy(pos)


@pytest.mark.parametrize("kvh,qkv_bias", [(4, False), (2, False), (1, False), (2, True)],
                         ids=["mha", "gqa", "mqa", "gqa-bias"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 5), (False, None)],
                         ids=["causal", "window5", "full"])
def test_attention_prefill_matches_reference(kvh, qkv_bias, causal, window):
    jp, tp = _attn_params(kvh, qkv_bias=qkv_bias, qk_norm=not qkv_bias)
    jcfg, cfg = _cfgs(kvh)
    S = 13
    x = _normal(1, B, S, D)
    jpos, tpos = _positions(S)
    want, _ = jx_attention(jnp.asarray(x), jp, jcfg, jpos, causal=causal, window=window)
    got, cache = att.attention(torch.from_numpy(x), tp, cfg, tpos, causal=causal, window=window)
    assert cache is None
    _close(got, want)


def test_cross_attention_matches_reference():
    jp, tp = _attn_params(2)
    jcfg, cfg = _cfgs(2)
    x, src = _normal(2, B, 5, D), _normal(3, B, 9, D)
    jpos, tpos = _positions(5)
    want, _ = jx_attention(jnp.asarray(x), jp, jcfg, jpos, x_kv=jnp.asarray(src))
    got, _ = att.attention(torch.from_numpy(x), tp, cfg, tpos, x_kv=torch.from_numpy(src))
    _close(got, want)


@pytest.mark.parametrize("S", [1, 6])
@pytest.mark.parametrize("kvh", [4, 2, 1])
def test_mha_grouped_matches_expanded(kvh, S):
    T = 11
    q, k, v = _normal(4, B, S, 4, 16), _normal(5, B, T, kvh, 16), _normal(6, B, T, kvh, 16)
    pos = np.broadcast_to(np.arange(T - S, T, dtype=np.int32)[None], (B, S)).copy()
    keep = att._mask(torch.from_numpy(pos), T, causal=True, window=None)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    grouped = att.mha(tq, tk, tv, keep, grouped=True)
    expanded = att.mha(tq, tk, tv, keep)
    np.testing.assert_allclose(grouped.numpy(), expanded.numpy(), rtol=RTOL, atol=ATOL)
    jkeep = jatt._mask(jnp.asarray(pos), T, causal=True, window=None)
    assert np.array_equal(keep.numpy(), np.asarray(jkeep))
    _close(grouped, jx_mha(*(jnp.asarray(a) for a in (q, k, v)), jkeep, grouped=True))


@pytest.mark.parametrize("T,block", [(17, 4), (24, 8), (9, 16)])
@pytest.mark.parametrize("window", [None, 6])
def test_blockwise_mha_matches_mha_and_reference(T, block, window):
    S, H = T, 4
    q, k, v = _normal(7, B, S, H, 16), _normal(8, B, T, H, 16), _normal(9, B, T, H, 16)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    tq, tk, tv, tpos = (torch.from_numpy(a) for a in (q, k, v, pos))
    got = att.blockwise_mha(tq, tk, tv, tpos, causal=True, window=window, block=block)
    dense = att.mha(tq, tk, tv, att._mask(tpos, T, causal=True, window=window))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=RTOL, atol=ATOL)
    want = jx_blockwise(*(jnp.asarray(a) for a in (q, k, v, pos)), causal=True,
                        window=window, block=block)
    _close(got, want)


def test_long_prefill_takes_the_blockwise_path(monkeypatch):
    """From FLASH_MIN_KV keys up, ``attention`` runs ``blockwise_mha`` (the
    threshold cut to 16 here) and still matches the reference's."""
    monkeypatch.setattr(att, "FLASH_MIN_KV", 16)
    monkeypatch.setattr(jatt, "FLASH_MIN_KV", 16)
    calls = []
    real = att.blockwise_mha
    monkeypatch.setattr(att, "blockwise_mha", lambda *a, **k: calls.append(1) or real(*a, **k))
    jp, tp = _attn_params(2)
    jcfg, cfg = _cfgs(2)
    x = _normal(10, B, 20, D)
    jpos, tpos = _positions(20)
    want, _ = jatt.attention(jnp.asarray(x), jp, jcfg, jpos)
    got, _ = att.attention(torch.from_numpy(x), tp, cfg, tpos)
    assert calls == [1]
    _close(got, want)


@pytest.mark.parametrize("S,idx", [(1, 0), (1, 7), (1, 15), (5, 0), (5, 3), (5, 11)])
def test_cache_write_matches_reference_exactly(S, idx):
    cache = _normal(11, B, 16, 2, 8)
    new = _normal(12, B, S, 2, 8)
    want = jatt.cache_write(jnp.asarray(cache), jnp.asarray(new), idx)
    got = att.cache_write(torch.from_numpy(cache), torch.from_numpy(new), idx)
    assert np.array_equal(got.numpy(), np.asarray(want))
    bf = att.cache_write(torch.from_numpy(cache).to(torch.bfloat16), torch.from_numpy(new), idx)
    want_bf = jatt.cache_write(jnp.asarray(cache, jnp.bfloat16), jnp.asarray(new), idx)
    assert np.array_equal(bf.float().numpy(), np.asarray(want_bf, np.float32))


@pytest.mark.parametrize("S,idx", [(1, 9), (4, 6)])
def test_attention_decode_matches_reference(S, idx):
    jp, tp = _attn_params(2)
    jcfg, cfg = _cfgs(2)
    cache = {"k": _normal(13, B, 12, 2, 16), "v": _normal(14, B, 12, 2, 16)}
    x = _normal(15, B, S, D)
    jpos, tpos = _positions(S, idx)
    want, wc = jx_attention(jnp.asarray(x), jp, jcfg, jpos,
                            cache={k: jnp.asarray(v) for k, v in cache.items()}, cache_idx=idx)
    got, gc = att.attention(torch.from_numpy(x), tp, cfg, tpos,
                            cache={k: torch.from_numpy(v) for k, v in cache.items()},
                            cache_idx=idx)
    _close(got, want)
    for key in ("k", "v"):
        _close(gc[key], wc[key])


@pytest.mark.parametrize("theta", [10_000.0, 1e6])
def test_rope_matches_reference(theta):
    pos = np.array([[0, 1, 7, 300], [5, 6, 7, 8]], np.int32)
    jc, js = jlay.rope_angles(jnp.asarray(pos), 16, theta)
    tc, ts = lay.rope_angles(torch.from_numpy(pos), 16, theta)
    _close(tc, jc)
    _close(ts, js)
    x = _normal(16, 2, 4, 3, 16)
    _close(lay.apply_rope(torch.from_numpy(x), tc, ts), jlay.apply_rope(jnp.asarray(x), jc, js))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_glu_matches_reference(act):
    decls = jlay.glu_decls(D, 96, act)
    jp = jx_init_params(jax.random.PRNGKey(1), decls)
    tp = params_from_reference(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    assert sorted(tp) == sorted(lay.glu_decls(D, 96, act))
    x = _normal(17, B, 5, D)
    _close(lay.glu(torch.from_numpy(x), tp, act), jlay.glu(jnp.asarray(x), jp, act))


@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_softmax_xent_matches_reference(z_loss):
    logits = _normal(18, B, 7, 300, scale=4.0)
    labels = np.random.default_rng(19).integers(0, 300, (B, 7)).astype(np.int32)
    want = jlay.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), z_loss)
    got = lay.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels), z_loss)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    bf = lay.softmax_xent(torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(labels))
    want_bf = jlay.softmax_xent(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels))
    np.testing.assert_allclose(float(bf), float(want_bf), rtol=RTOL)
