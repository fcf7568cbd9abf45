"""The port's RWKV-6 model and serving path against the JAX package at
``rwkv6-smoke``, on the CPU, with the same weights and inputs.

Weights come from the reference's ``init_params`` and reach the port through
``params_from_reference``; inputs are made with numpy.  Tolerances:

* float32: rtol = atol = 1e-4.  The two packages compute the same float32
  expressions, but the matrix products and the WKV sums run in different
  orders (the port's chunked recurrence against the reference's vmapped
  jnp version), a few ulps each, over two layers.
* bfloat16 activations: rtol = 2e-2 and atol = 2e-2 · max(1, max|ref|) of
  the compared array, about five bf16 ulps at the array's scale: both round
  every activation to bf16 at the same places, and a product that rounds the
  other way moves a value by one ulp of its operands, so a residual sum that
  cancels keeps an error of the residual stream's scale.  The
  reference runs with ``scan_layers=False`` here: its layer loop then runs
  op by op, as PyTorch does, and rounds to bf16 after every op.  Its
  ``lax.scan`` body is one compiled XLA program that keeps excess precision
  between bf16 ops, so it does not round where its own source says it does.
"""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny model: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jx_get_smoke  # noqa: E402
from repro.models import get_api as jx_get_api  # noqa: E402
from repro.models import rwkv as jx_rwkv  # noqa: E402
from repro.models import transformer as jx_tf  # noqa: E402
from repro.models.params import init_params as jx_init_params  # noqa: E402
from repro.serve.decode import generate as jx_generate  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_api, rwkv  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.params import count_params, init_params  # noqa: E402
from repro_torch.serve.decode import generate, sample_token  # noqa: E402

TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}  # (rtol, atol at scale 1)
SEQ = [1, 7, 40]
B = 2


def _configs(act: str):
    jcfg = jx_get_smoke("rwkv6-7b").replace(act_dtype=act, scan_layers=act == "float32")
    return jcfg, get_smoke("rwkv6-7b").replace(act_dtype=act)


def _params(jcfg, seed=0):
    jp = jx_init_params(jax.random.PRNGKey(seed), jx_get_api(jcfg).decls(jcfg))
    return jp, params_from_reference(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _pair(a: np.ndarray, act: str):
    """The same values for both packages, in the activation dtype."""
    if act == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _state(cfg, seed, act):
    """A carried per-layer state: token-shift carries and a WKV state."""
    rng = np.random.default_rng(seed)
    D, hs = cfg.d_model, cfg.rwkv.head_size
    tm, cm = (rng.normal(size=(B, D)).astype(np.float32) for _ in range(2))
    wkv = (rng.normal(size=(B, D // hs, hs, hs)) * 0.2).astype(np.float32)
    (jtm, ttm), (jcm, tcm) = _pair(tm, act), _pair(cm, act)
    return ({"tm_shift": jtm, "cm_shift": jcm, "wkv": jnp.asarray(wkv)},
            {"tm_shift": ttm, "cm_shift": tcm, "wkv": torch.from_numpy(wkv)})


def _close(port, ref, act):
    want = np.asarray(jnp.asarray(ref, jnp.float32))
    rtol, atol = TOL[act]
    if act == "bfloat16":
        atol *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(port.float().numpy(), want, rtol=rtol, atol=atol)


def _close_tree(port, ref, act):
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref)
        for key in port:
            _close_tree(port[key], ref[key], act)
    else:
        _close(port, ref, act)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    act = request.param
    jcfg, cfg = _configs(act)
    jp, tp = _params(jcfg)
    return act, jcfg, cfg, jp, tp


@pytest.mark.parametrize("seed", [0, 5])
def test_params_from_reference_is_exact(seed):
    jcfg, cfg = _configs("float32")
    jp, tp = _params(jcfg, seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jp)
    assert len(leaves) == 24
    for path, leaf in leaves:
        node = tp
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), np.asarray(leaf)), jax.tree_util.keystr(path)
    assert count_params(tf.lm_decls(cfg)) == sum(np.asarray(x).size for _, x in leaves)


def test_full_config_has_the_reference_parameter_count():
    assert count_params(tf.lm_decls(get_config("rwkv6-7b"))) == 7_576_621_056


@pytest.mark.parametrize("S", SEQ)
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("fn", ["time_mix", "channel_mix", "rwkv_block"])
def test_block_functions_match_the_reference(model, fn, S, carried):
    act, jcfg, cfg, jp, tp = model
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    tl = tf.layer(tp["layers"], 0)
    x = np.random.default_rng(S).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    jx, tx = _pair(x, act)
    jst, tst = _state(cfg, 10 + S, act) if carried else (None, None)
    if fn == "time_mix":
        jkw = {"shift_prev": jst["tm_shift"], "wkv_state": jst["wkv"]} if carried else {}
        tkw = {"shift_prev": tst["tm_shift"], "wkv_state": tst["wkv"]} if carried else {}
        want = jx_rwkv.time_mix(jx, jl["tm"], jcfg, **jkw)
        got = rwkv.time_mix(tx, tl["tm"], cfg, **tkw)
    elif fn == "channel_mix":
        want = jx_rwkv.channel_mix(jx, jl["cm"], jcfg,
                                   shift_prev=jst["cm_shift"] if carried else None)
        got = rwkv.channel_mix(tx, tl["cm"], cfg, shift_prev=tst["cm_shift"] if carried else None)
    else:
        want = jx_rwkv.rwkv_block(jx, jl, jcfg, state=jst)
        got = rwkv.rwkv_block(tx, tl, cfg, state=tst)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close_tree(g, w, act)
    assert got[0].dtype == cfg.adt()


@pytest.mark.parametrize("S", SEQ)
def test_lm_forward_matches_the_reference(model, S):
    act, jcfg, cfg, jp, tp = model
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want, _, want_hidden = jx_tf.lm_forward(jp, jnp.asarray(toks), jcfg)
    got, aux, hidden = tf.lm_forward(tp, torch.from_numpy(toks).long(), cfg)
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == cfg.adt()
    _close(got, want, act)
    _close(hidden, want_hidden, act)
    assert float(aux) == 0.0


def test_init_cache_matches_the_reference(model):
    act, jcfg, cfg, _, _ = model
    want = jx_tf.init_cache(jcfg, B, 16)
    got = tf.init_cache(cfg, B, 16, device="cpu")
    assert sorted(got) == sorted(want)
    for key in got:
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == (torch.float32 if key == "wkv" else cfg.adt())
        assert not got[key].any()


@pytest.mark.parametrize("S", SEQ)
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_decode_step_matches_the_reference(model, S, carried):
    act, jcfg, cfg, jp, tp = model
    jcache, tcache = jx_tf.init_cache(jcfg, B, 64), tf.init_cache(cfg, B, 64, device="cpu")
    if carried:  # a different carried state in each layer
        states = [_state(cfg, 20 + i, act) for i in range(cfg.num_layers)]
        jcache = {k: jnp.stack([s[0][k] for s in states]) for k in jcache}
        tcache = {k: torch.stack([s[1][k] for s in states]) for k in tcache}
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want, want_cache = jx_tf.decode_step(jp, jcache, jnp.asarray(toks), jnp.int32(3), jcfg)
    got, got_cache = tf.decode_step(tp, tcache, torch.from_numpy(toks).long(), 3, cfg)
    _close(got, want, act)
    _close_tree(got_cache, want_cache, act)


@pytest.mark.parametrize("batch,prompt_len,new", [(2, 5, 4), (1, 40, 8)])
def test_greedy_generate_gives_the_reference_tokens(batch, prompt_len, new):
    jcfg, cfg = _configs("float32")
    jp, tp = _params(jcfg, seed=1)
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    want = np.asarray(jx_generate(jp, jcfg, jnp.asarray(prompt), new))
    got = generate(tp, cfg, torch.from_numpy(prompt), new)
    assert got.dtype == torch.int32 and got.shape == (batch, prompt_len + new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_matches_prefill():
    """Token-by-token decode logits equal the full forward's, as the
    reference's ``test_decode_matches_prefill_rwkv`` holds them."""
    cfg = get_smoke("rwkv6-7b")
    api = get_api(cfg)
    params = init_params(torch.Generator().manual_seed(2), api.decls(cfg), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 10), generator=torch.Generator().manual_seed(3))
    full = api.prefill(params, {"tokens": toks}, cfg)
    cache = api.init_cache(cfg, 1, 10, device="cpu")
    outs = []
    for i in range(10):
        logits, cache = api.decode_step(params, cache, toks[:, i:i + 1], i, cfg)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(full.numpy(), dec.numpy(), rtol=5e-3, atol=5e-3)
    chunked, _ = api.decode_step(params, api.init_cache(cfg, 1, 10, device="cpu"), toks, 0, cfg)
    np.testing.assert_allclose(full.numpy(), chunked.numpy(), rtol=1e-6, atol=1e-6)


def test_sampling_with_a_temperature_is_seeded():
    logits = torch.randn((3, 2, 50), generator=torch.Generator().manual_seed(0))
    draw = [sample_token(logits, torch.Generator().manual_seed(s), 0.8) for s in (7, 7, 8)]
    assert torch.equal(draw[0], draw[1]) and draw[0].shape == (3, 1)
    assert torch.equal(sample_token(logits), logits[:, -1].argmax(-1, keepdim=True).int())


def test_serve_cli_runs_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "8", "--new", "4"])
    lines = out.getvalue().splitlines()
    assert rc == 0 and len(lines) == 3 and all(line.startswith("[serve]") for line in lines)
    assert "prefill 2x8" in lines[0] and "8 tokens in" in lines[1]


def test_unported_families_name_their_slice():
    with pytest.raises(NotImplementedError, match="Model zoo: VLM"):
        get_config("pixtral-12b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    cfg = get_smoke("rwkv6-7b").replace(name="hybrid-like", family="hybrid")
    with pytest.raises(NotImplementedError, match="Model zoo: the hybrid family"):
        tf.lm_decls(cfg)
    with pytest.raises(NotImplementedError, match="Model zoo: the hybrid family"):
        get_api(get_smoke("rwkv6-7b")).loss(None, {"tokens": None}, cfg)
