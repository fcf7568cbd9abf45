"""The port's hybrid family (``repro_torch.models.griffin`` and the
``hybrid`` branches of ``repro_torch.models.transformer``) against the JAX
package at ``recurrentgemma-smoke`` (5 layers: one unit of rec, rec, attn
and a tail of two rec layers; window 8), on the CPU, with the same weights
(the reference's ``init_params`` through ``params_from_reference``, the
zero-initialised biases given values) and inputs made with numpy.

Tolerances:

* float32: rtol = atol = 1e-5 on the RG-LRU, the conv, the blocks, logits,
  hidden states and caches, rtol = 1e-5 on the loss: the same float32
  expressions, the scan's combines in the same tree, summed in other orders
  (XLA contracts ``a2·b1 + b2`` into an FMA, the matrix products block
  differently).  Gradients: rtol = 1e-4, atol = 1e-6 · max(1, max|ref|)
  (a gradient sums more terms than a loss).  Greedy tokens are exact.
* bfloat16 activations: rtol = 2e-2 and atol = 2e-2 · max(1, max|ref|) of
  the compared array, rtol = 2e-3 on the loss.  Here the model's reference
  runs op by op (``jax.disable_jit()``, layers unrolled), rounding to bf16
  after every op as PyTorch does: jitted, XLA keeps excess precision between
  the bf16 ops of a fused body (the conv's taps, the gates), and at this
  config its hidden state strays 0.13 from the op-by-op one, past the
  tolerance, where the port's forward equals the op-by-op run bit for bit.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny model: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jx_get_config  # noqa: E402
from repro.configs import get_smoke as jx_get_smoke  # noqa: E402
from repro.models import get_api as jx_get_api  # noqa: E402
from repro.models import griffin as jx_griffin  # noqa: E402
from repro.models import transformer as jx_tf  # noqa: E402
from repro.models.params import count_params as jx_count_params  # noqa: E402
from repro.models.params import init_params as jx_init_params  # noqa: E402
from repro.serve.decode import generate as jx_generate  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import get_api, griffin  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.params import count_params, init_params  # noqa: E402
from repro_torch.serve.decode import generate  # noqa: E402

ARCH = "recurrentgemma-2b"
FULL_PARAMS = 2_682_237_440  # the reference's count_params of the full config
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}  # (rtol, atol at scale 1)
SCAN_S = [1, 2, 3, 5, 8, 13, 64]
B = 2

jx_forward = jax.jit(jx_tf.lm_forward, static_argnums=(2,))
jx_loss = jax.jit(jx_tf.lm_loss, static_argnums=(2,))
jx_decode = jax.jit(jx_tf.decode_step, static_argnums=(4,))


def _configs(act: str = "float32"):
    jcfg = jx_get_smoke(ARCH).replace(act_dtype=act, scan_layers=act == "float32")
    return jcfg, get_smoke(ARCH).replace(act_dtype=act)


def _with_biases(tree, rng):
    """The zero-initialised biases given values, so the tests see them."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.1)
                    if k in ("conv_b", "gate_a_b", "gate_x_b") else _with_biases(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_biases(v, rng) for v in tree]
    return tree


def _params(jcfg, seed=0):
    jp = jx_init_params(jax.random.PRNGKey(seed), jx_get_api(jcfg).decls(jcfg))
    jp = _with_biases(jp, np.random.default_rng(seed))
    return jp, params_from_reference(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _reference(act):
    """The context the model's reference runs in: jitted in float32, op by
    op in bfloat16."""
    return jax.disable_jit() if act == "bfloat16" else contextlib.nullcontext()


def _close(port, ref, act="float32"):
    want = np.asarray(jnp.asarray(ref, jnp.float32))
    rtol, atol = TOL[act]
    if act == "bfloat16":
        atol *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(port.float().numpy(), want, rtol=rtol, atol=atol)


def _close_tree(port, ref, act="float32"):
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref)
        for key in port:
            _close_tree(port[key], ref[key], act)
    elif isinstance(port, list):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _close_tree(p, r, act)
    else:
        _close(port, ref, act)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _tokens(cfg, S, seed, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)


@pytest.fixture(scope="module", params=list(TOL))
def model(request):
    act = request.param
    jcfg, cfg = _configs(act)
    jp, tp = _params(jcfg)
    return act, jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def rec_layer():
    """The first unit's first recurrent layer, both packages' weights."""
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, seed=3)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["units"]["b0_rec"])
    tl = tf.layer(tp["units"]["b0_rec"], 0)
    return jcfg, cfg, jl, tl


def test_params_from_reference_carry_the_hybrid_tree():
    """``units`` (stacked over the repeats of the pattern) and ``tail`` (a
    list), leaf for leaf."""
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, seed=5)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in leaves:
        node = tp
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), np.asarray(leaf)), jax.tree_util.keystr(path)
    assert sorted(tp["units"]) == ["b0_rec", "b1_rec", "b2_attn"]
    assert isinstance(tp["tail"], list) and len(tp["tail"]) == 2
    assert all("rec" in lp for lp in tp["tail"])
    assert tp["units"]["b0_rec"]["rec"]["gate_a"].shape == (1, griffin.LRU_BLOCKS, 6, 6)
    assert count_params(tf.lm_decls(cfg)) == sum(np.asarray(x).size for _, x in leaves)


def test_configs_are_the_reference_configs():
    for port, ref in ((get_config(ARCH), jx_get_config(ARCH)),
                      (get_smoke(ARCH), jx_get_smoke(ARCH))):
        for field in dataclasses.fields(ref):
            want, got = getattr(ref, field.name), getattr(port, field.name)
            if dataclasses.is_dataclass(want):
                assert dataclasses.asdict(got) == dataclasses.asdict(want), field.name
            else:
                assert got == want, field.name


def test_full_config_has_the_reference_parameter_count():
    cfg, jcfg = get_config(ARCH), jx_get_config(ARCH)
    assert count_params(tf.lm_decls(cfg)) == jx_count_params(jx_get_api(jcfg).decls(jcfg))
    assert count_params(get_api(cfg).decls(cfg)) == FULL_PARAMS


def test_associative_scan_is_the_linear_recurrence():
    """The tree against a float64 loop over the sequence, at odd and even
    lengths."""
    for S in (1, 2, 7, 16, 33):
        a = torch.rand((2, S, 3), dtype=torch.float64, generator=torch.Generator().manual_seed(S))
        b = torch.randn((2, S, 3), dtype=torch.float64, generator=torch.Generator().manual_seed(S))
        _, h = griffin.associative_scan(a, b)
        want, acc = [], torch.zeros((2, 3), dtype=torch.float64)
        for t in range(S):
            acc = a[:, t] * acc + b[:, t]
            want.append(acc)
        np.testing.assert_allclose(h.numpy(), torch.stack(want, 1).numpy(), rtol=1e-12)


@pytest.mark.parametrize("S", SCAN_S)
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "h0"])
def test_rg_lru_matches_the_reference(rec_layer, S, carried):
    jcfg, cfg, jl, tl = rec_layer
    W = cfg.griffin.lru_width
    x = _normal(S, B, S, W)
    h0 = _normal(100 + S, B, W) if carried else None
    fn = jax.jit(functools.partial(jx_griffin.rg_lru, c_scale=cfg.griffin.c_scale))
    want_h, want_last = fn(jnp.asarray(x), jl["rec"], h0=None if h0 is None else jnp.asarray(h0))
    got_h, got_last = griffin.rg_lru(torch.from_numpy(x), tl["rec"], cfg.griffin.c_scale,
                                     None if h0 is None else torch.from_numpy(h0))
    assert got_h.shape == (B, S, W) and got_h.dtype == torch.float32
    _close(got_h, want_h)
    _close(got_last, want_last)


@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("with_tail", [False, True], ids=["zeros", "tail"])
@pytest.mark.parametrize("act", list(TOL))
def test_conv1d_matches_the_reference(rec_layer, S, with_tail, act):
    jcfg, cfg, jl, tl = rec_layer
    K, W = cfg.griffin.conv_width, cfg.griffin.lru_width
    dt, jdt = cfg.replace(act_dtype=act).adt(), jcfg.replace(act_dtype=act).adt()
    x = _normal(S + 20, B, S, W)
    tail = _normal(S + 30, B, K - 1, W) if with_tail else None
    want, want_tail = jax.jit(jx_griffin._conv1d)(
        jnp.asarray(x, jdt), jl["rec"]["conv_w"], jl["rec"]["conv_b"],
        None if tail is None else jnp.asarray(tail, jdt))
    got, got_tail = griffin._conv1d(torch.from_numpy(x).to(dt), tl["rec"]["conv_w"],
                                    tl["rec"]["conv_b"],
                                    None if tail is None else torch.from_numpy(tail).to(dt))
    assert got.dtype == got_tail.dtype == dt and got_tail.shape == (B, K - 1, W)
    _close(got, want, act)
    _close(got_tail, want_tail, act)


@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "state"])
def test_recurrent_block_matches_the_reference(rec_layer, S, carried):
    jcfg, cfg, jl, tl = rec_layer
    g = cfg.griffin
    x = _normal(S + 40, B, S, cfg.d_model)
    state = None
    if carried:
        state = {"conv": _normal(S + 41, B, g.conv_width - 1, g.lru_width),
                 "lru": _normal(S + 42, B, g.lru_width)}
    want, want_state = jax.jit(functools.partial(jx_griffin.recurrent_block, cfg=jcfg))(
        jnp.asarray(x), jl["rec"],
        state=None if state is None else {k: jnp.asarray(v) for k, v in state.items()})
    got, got_state = griffin.recurrent_block(
        torch.from_numpy(x), tl["rec"], cfg,
        None if state is None else {k: torch.from_numpy(v) for k, v in state.items()})
    _close(got, want)
    _close_tree(got_state, want_state)


@pytest.mark.parametrize("pos", [0, 3, 7, 8, 20])
def test_griffin_attn_decode_matches_the_reference(pos):
    """One token against the rolling window of 8, with positions before,
    at and past the window's length (slots before position 0 masked)."""
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, seed=4)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["units"]["b2_attn"]["attn"])
    tl = tf.layer(tp["units"]["b2_attn"]["attn"], 0)
    W = cfg.griffin.window
    x = _normal(pos, B, 1, cfg.d_model)
    cache = {k: _normal(pos + i, B, W, cfg.num_kv_heads, cfg.hd()) for i, k in
             enumerate(("k", "v"))}
    want, want_cache = jax.jit(functools.partial(jx_griffin.griffin_attn_decode, cfg=jcfg))(
        jnp.asarray(x), jl, pos=jnp.int32(pos),
        cache={k: jnp.asarray(v) for k, v in cache.items()})
    for p in (pos, torch.tensor(pos)):  # an int and a device tensor
        got, got_cache = griffin.griffin_attn_decode(
            torch.from_numpy(x), tl, cfg, p, {k: torch.from_numpy(v) for k, v in cache.items()})
        _close(got, want)
        _close_tree(got_cache, want_cache)


def test_lm_forward_matches_the_reference(model):
    act, jcfg, cfg, jp, tp = model
    S = 12  # past the window of 8
    toks = _tokens(cfg, S, S)
    with _reference(act):
        want, _, want_hidden = jx_forward(jp, jnp.asarray(toks), jcfg)
    got, aux, hidden = tf.lm_forward(tp, torch.from_numpy(toks), cfg)
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == cfg.adt()
    _close(got, want, act)
    _close(hidden, want_hidden, act)
    assert float(aux) == 0.0


def test_lm_loss_matches_the_reference(model):
    act, jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 12, 4)
    batch = {"tokens": toks, "labels": np.roll(toks, 1, axis=1)}
    with _reference(act):
        want, wm = jx_loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    got, gm = tf.lm_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert sorted(gm) == sorted(wm) == ["moe_aux", "xent"]
    rtol = 1e-5 if act == "float32" else 2e-3
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    np.testing.assert_allclose(float(gm["xent"]), float(wm["xent"]), rtol=rtol)


def test_lm_loss_gradients_match_jax_grad():
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, seed=7)
    toks = _tokens(cfg, 11, 11)
    batch = {"tokens": toks, "labels": toks}
    want = jax.jit(jax.grad(lambda p: jx_tf.lm_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)[0]))(jp)
    leaves = [p.detach().requires_grad_(True) for p in jax.tree_util.tree_leaves(tp)]
    tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp), leaves)
    loss, _ = tf.lm_loss(tree, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(paths) == len(grads)
    for (path, ref), g in zip(paths, grads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-6 * max(1.0, float(np.abs(ref).max())),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("max_seq", [5, 16])
def test_init_cache_matches_the_reference(model, max_seq):
    """The window is min(window, max_seq); the RG-LRU state is float32."""
    act, jcfg, cfg, _, _ = model
    want = jx_tf.init_cache(jcfg, B, max_seq)
    got = tf.init_cache(cfg, B, max_seq, device="cpu")
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got_leaves] == [
        jax.tree_util.keystr(p) for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape and not g.any(), jax.tree_util.keystr(path)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), jax.tree_util.keystr(path)


def test_decode_step_matches_the_reference(model):
    """Twelve one-token steps, past the window of 8: every step's logits and
    cache."""
    act, jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 12, 5)
    jcache, tcache = jx_tf.init_cache(jcfg, B, 16), tf.init_cache(cfg, B, 16, device="cpu")
    for i in range(12):
        with _reference(act):
            want, jcache = jx_decode(jp, jcache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i),
                                     jcfg)
        got, tcache = tf.decode_step(tp, tcache, torch.from_numpy(toks[:, i:i + 1]), i, cfg)
        _close(got, want, act)
        _close_tree(tcache, jcache, act)


def test_decode_matches_prefill_griffin():
    """Token-by-token decode logits equal the full forward's, as the
    reference's ``test_decode_matches_prefill_griffin`` holds them."""
    cfg = get_smoke(ARCH)
    api = get_api(cfg)
    params = init_params(torch.Generator().manual_seed(2), api.decls(cfg), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 12), generator=torch.Generator().manual_seed(3))
    full = api.prefill(params, {"tokens": toks}, cfg)
    cache = api.init_cache(cfg, 1, 12, device="cpu")
    outs = []
    for i in range(12):
        logits, cache = api.decode_step(params, cache, toks[:, i:i + 1], i, cfg)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(full.numpy(), torch.stack(outs, 1).numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batch,prompt_len,new", [(2, 5, 4), (1, 12, 6), (2, 9, 9)])
def test_greedy_generate_gives_the_reference_tokens(batch, prompt_len, new):
    """Prompts shorter and longer than the window of 8, warmed token by
    token."""
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, seed=1)
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    want = np.asarray(jx_generate(jp, jcfg, jnp.asarray(prompt), new))
    got = generate(tp, cfg, torch.from_numpy(prompt), new)
    assert got.dtype == torch.int32 and got.shape == (batch, prompt_len + new)
    np.testing.assert_array_equal(got.numpy(), want)
