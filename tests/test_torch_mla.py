"""The port's Multi-head Latent Attention (``repro_torch.models.mla``) against
the JAX package's ``mla_attention`` on the CPU, at ``deepseek-v3-smoke``'s
widths (d_model 64, 4 heads, q_lora 32, kv_lora 16, rope 8, nope 16, v 16),
with the same weights and inputs.

Tolerances (float32): rtol = atol = 1e-5 on outputs and caches, as the
dense attention's (``tests/test_torch_attention.py``): the same float32
expressions, their products and softmax sums summed in another order.  The
absorbed chunked prefill is held to the expanded forward of the same tokens
at the same tolerance: the two differ only in where the k/v up-projections
are applied.  The blockwise branch (S ≥ ``FLASH_MIN_KV`` = 8,192) is held to
the reference's blockwise branch at rtol = atol = 1e-4: running maxima and
sums over 8 blocks of 1,024 keys, in float32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny model: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jx_get_smoke  # noqa: E402
from repro.models import mla as jx_mla  # noqa: E402
from repro.models.params import init_params as jx_init_params  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.attention import FLASH_MIN_KV  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402

ARCH = "deepseek-v3-671b"
B = 2


def _setup(seed=0):
    jcfg, cfg = jx_get_smoke(ARCH), get_smoke(ARCH)
    jp = jx_init_params(jax.random.PRNGKey(seed), jx_mla.mla_decls(jcfg))
    return jcfg, cfg, jp, params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                                device="cpu")


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


def _pos(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None], (b, s)).copy()


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def _empty_cache(cfg, b, t):
    m = cfg.mla
    return {"ckv": np.zeros((b, t, m.kv_lora), np.float32),
            "krope": np.zeros((b, t, m.rope_dim), np.float32)}


def test_decls_are_the_reference_shapes():
    jcfg, cfg, jp, tp = _setup()
    assert sorted(tp) == sorted(jp)
    for key in jp:
        assert tuple(tp[key].shape) == jp[key].shape, key


@pytest.mark.parametrize("s", [1, 9, 33])
def test_expanded_path_matches_the_reference(s):
    jcfg, cfg, jp, tp = _setup()
    x, pos = _x(cfg, B, s, s), _pos(B, s)
    want, wc = jx_mla.mla_attention(jnp.asarray(x), jp, jcfg, jnp.asarray(pos))
    got, gc = mla.mla_attention(torch.from_numpy(x), tp, cfg, torch.from_numpy(pos))
    assert wc is None and gc is None
    _close(got, want)


def test_absorbed_path_matches_the_reference():
    """A chunked prefill of 7 tokens at idx 0, then two one-token steps,
    through the latent cache."""
    jcfg, cfg, jp, tp = _setup(1)
    x = _x(cfg, B, 9, 4)
    jcache = {k: jnp.asarray(v) for k, v in _empty_cache(cfg, B, 12).items()}
    tcache = {k: torch.from_numpy(v) for k, v in _empty_cache(cfg, B, 12).items()}
    for start, stop in ((0, 7), (7, 8), (8, 9)):
        pos = _pos(B, stop - start, start)
        want, jcache = jx_mla.mla_attention(jnp.asarray(x[:, start:stop]), jp, jcfg,
                                            jnp.asarray(pos), cache=jcache,
                                            cache_idx=jnp.int32(start))
        got, tcache = mla.mla_attention(torch.from_numpy(x[:, start:stop]), tp, cfg,
                                        torch.from_numpy(pos), cache=tcache, cache_idx=start)
        _close(got, want)
        for key in ("ckv", "krope"):
            _close(tcache[key], jcache[key])


def test_absorbed_chunked_prefill_matches_the_expanded_forward():
    _, cfg, _, tp = _setup(2)
    x, pos = torch.from_numpy(_x(cfg, B, 11, 5)), torch.from_numpy(_pos(B, 11))
    expanded, _ = mla.mla_attention(x, tp, cfg, pos)
    cache = {k: torch.from_numpy(v) for k, v in _empty_cache(cfg, B, 11).items()}
    absorbed, _ = mla.mla_attention(x, tp, cfg, pos, cache=cache, cache_idx=0)
    np.testing.assert_allclose(absorbed.numpy(), expanded.numpy(), rtol=1e-5, atol=1e-5)


def test_blockwise_branch_at_flash_length_matches_the_reference():
    """S = 8,192 takes ``blockwise_mha`` in both packages; its scale is the
    concatenated (nope + rope) width's, the expanded path's own."""
    jcfg, cfg, jp, tp = _setup(3)
    s = FLASH_MIN_KV
    assert s == 8192
    x, pos = _x(cfg, 1, s, 6), _pos(1, s)
    want, _ = jax.jit(lambda xx, pp: jx_mla.mla_attention(xx, jp, jcfg, pp))(
        jnp.asarray(x), jnp.asarray(pos))
    got, _ = mla.mla_attention(torch.from_numpy(x), tp, cfg, torch.from_numpy(pos))
    _close(got, want, tol=1e-4)
