"""The port's dense and MoE families (``repro_torch.models.transformer``)
against the JAX package at ``qwen3-smoke`` (qk-norm, tied head),
``qwen2-smoke`` (QKV bias, untied head), ``minitron-smoke`` (relu² MLP,
untied head), ``deepseek-v3-smoke`` (MLA, a leading dense layer, routed
layers of 8 experts, multi-token prediction with ``mtp_depth=1``) and
``kimi-k2-smoke`` (GQA, 12 experts), on the CPU, with the same weights (the
reference's ``init_params`` through ``params_from_reference``) and the same
tokens.

Tolerances:

* float32: rtol = 1e-5 on the loss; rtol = atol = 1e-5 on logits, hidden
  states and caches: the same float32 expressions, their products and
  softmax sums summed in different orders, over two layers.  Greedy tokens
  are exact.
* bfloat16 activations: rtol = 2e-2 and atol = 2e-2 · max(1, max|ref|) of
  the compared array (about five bf16 ulps at the array's scale); rtol =
  2e-3 on the loss.  The reference runs its layers unrolled
  (``scan_layers=False``, as in ``tests/test_torch_rwkv.py``) in one jitted
  program, where XLA may keep excess precision between bf16 ops that
  PyTorch rounds; the tolerance holds that too.
* MoE (float32): the same as float32 above, the aux loss and the MTP loss
  included (rtol 1e-5); the routing is exact at these inputs (no token's
  router probabilities tie within the float32 rounding of either side).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny model: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jx_get_config  # noqa: E402
from repro.configs import get_smoke as jx_get_smoke  # noqa: E402
from repro.models import get_api as jx_get_api  # noqa: E402
from repro.models import transformer as jx_tf  # noqa: E402
from repro.models.params import count_params as jx_count_params  # noqa: E402
from repro.models.params import init_params as jx_init_params  # noqa: E402
from repro.serve.decode import generate as jx_generate  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.models import get_api  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.params import count_params, init_params  # noqa: E402
from repro_torch.serve.decode import generate  # noqa: E402

ARCHS = ["qwen3-1.7b", "qwen2-72b", "minitron-8b"]
DENSE = ARCHS + ["qwen1.5-110b"]
MOE = ["deepseek-v3-671b", "kimi-k2-1t-a32b"]
# the full MoE configs' parameters (the reference's count_params, in billions)
MOE_PARAMS = {"deepseek-v3-671b": 671.026404352, "kimi-k2-1t-a32b": 1028.298994688}
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}  # (rtol, atol at scale 1)
B = 2

jx_forward = jax.jit(jx_tf.lm_forward, static_argnums=(2,))
jx_loss = jax.jit(jx_tf.lm_loss, static_argnums=(2,))
jx_decode = jax.jit(jx_tf.decode_step, static_argnums=(4,))


def _configs(arch: str, act: str = "float32"):
    jcfg = jx_get_smoke(arch).replace(act_dtype=act, scan_layers=act == "float32")
    cfg = get_smoke(arch).replace(act_dtype=act)
    if arch == "deepseek-v3-671b":  # the multi-token prediction head too
        return jcfg.replace(mtp_depth=1), cfg.replace(mtp_depth=1)
    return jcfg, cfg


def _params(jcfg, seed=0):
    jp = jx_init_params(jax.random.PRNGKey(seed), jx_get_api(jcfg).decls(jcfg))
    if jcfg.qkv_bias:  # the biases init to zeros: give them values
        rng = np.random.default_rng(seed)
        attn = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.1)
                    if k in ("bq", "bk", "bv") else v) for k, v in jp["layers"]["attn"].items()}
        jp = {**jp, "layers": {**jp["layers"], "attn": attn}}
    return jp, params_from_reference(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


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
    else:
        _close(port, ref, act)


def _tokens(cfg, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module", params=[(a, act) for a in ARCHS for act in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    arch, act = request.param
    jcfg, cfg = _configs(arch, act)
    jp, tp = _params(jcfg)
    return act, jcfg, cfg, jp, tp


@pytest.fixture(scope="module", params=MOE)
def moe_model(request):
    jcfg, cfg = _configs(request.param)
    jp, tp = _params(jcfg, seed=7)
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_carry_the_dense_tree(arch):
    jcfg, cfg = _configs(arch)
    jp, tp = _params(jcfg, seed=3)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in leaves:
        node = tp
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), np.asarray(leaf)), jax.tree_util.keystr(path)
    attn, L, d, hd = tp["layers"]["attn"], cfg.num_layers, cfg.d_model, cfg.hd()
    assert attn["wq"].shape == (L, d, cfg.num_heads, hd)
    assert attn["wo"].shape == (L, cfg.num_heads, hd, d)
    assert ("q_norm" in attn) == ("k_norm" in attn) == cfg.qk_norm
    assert ("bq" in attn) == ("bv" in attn) == cfg.qkv_bias
    assert ("wu" in tp["layers"]["mlp"]) == (cfg.mlp_act != "relu2")
    assert ("head" in tp) == (not cfg.tie_embeddings)
    assert count_params(tf.lm_decls(cfg)) == sum(np.asarray(x).size for _, x in leaves)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_full_configs_have_the_reference_parameter_count(arch):
    cfg, jcfg = get_config(arch), jx_get_config(arch)
    assert cfg == get_config(arch) and cfg.name == jcfg.name
    assert count_params(tf.lm_decls(cfg)) == jx_count_params(jx_get_api(jcfg).decls(jcfg))
    if arch in MOE:
        assert count_params(tf.lm_decls(cfg)) == round(MOE_PARAMS[arch] * 1e9)


@pytest.mark.parametrize("arch", MOE)
def test_moe_configs_are_the_reference_configs(arch):
    for port, ref in ((get_config(arch), jx_get_config(arch)),
                      (get_smoke(arch), jx_get_smoke(arch))):
        for field in dataclasses.fields(ref):
            want = getattr(ref, field.name)
            got = getattr(port, field.name)
            if dataclasses.is_dataclass(want):
                assert dataclasses.asdict(got) == dataclasses.asdict(want), field.name
            else:
                assert got == want, field.name


def test_params_from_reference_carry_the_moe_tree(moe_model):
    """``dense_layers``, the routed ``layers`` (router, experts, the shared
    expert), MLA's weights and the ``mtp`` tree, leaf for leaf."""
    jcfg, cfg, jp, tp = moe_model
    leaves, _ = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in leaves:
        node = tp
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), np.asarray(leaf)), jax.tree_util.keystr(path)
    m, n_dense = cfg.moe, cfg.moe.first_dense_layers
    assert ("dense_layers" in tp) == (n_dense > 0) and ("mtp" in tp) == (cfg.mtp_depth > 0)
    mlp = tp["layers"]["mlp"]
    assert mlp["wg"].shape == (cfg.num_layers - n_dense, m.num_experts, cfg.d_model,
                               m.expert_ff)
    assert mlp["router"].shape == (cfg.num_layers - n_dense, cfg.d_model, m.num_experts)
    assert tp["dense_layers"]["mlp"]["wg"].shape == (n_dense, cfg.d_model, m.dense_ff)
    assert ("ckv" in init_cache_keys(cfg)) == (cfg.mla is not None)
    assert ("wkv_down" in tp["layers"]["attn"]) == (cfg.mla is not None)
    assert count_params(tf.lm_decls(cfg)) == sum(np.asarray(x).size for _, x in leaves)


def init_cache_keys(cfg):
    return sorted(tf.init_cache(cfg, 1, 4, device="cpu")["layers"])


def test_moe_lm_forward_matches_the_reference(moe_model):
    jcfg, cfg, jp, tp = moe_model
    toks = _tokens(cfg, 10, 10)
    want, want_aux, want_hidden = jx_forward(jp, jnp.asarray(toks), jcfg)
    got, aux, hidden = tf.lm_forward(tp, torch.from_numpy(toks), cfg)
    assert got.shape == (B, 10, cfg.vocab_size) and aux.dtype == torch.float32
    _close(got, want)
    _close(hidden, want_hidden)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert float(aux) > 0


def test_moe_lm_loss_matches_the_reference(moe_model):
    """The loss with the aux term and, for deepseek, the MTP term."""
    jcfg, cfg, jp, tp = moe_model
    toks = _tokens(cfg, 12, 6)
    batch = {"tokens": toks, "labels": np.roll(toks, 1, axis=1)}
    want, wm = jx_loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    got, gm = tf.lm_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    keys = ["moe_aux", "xent"] + (["mtp"] if cfg.mtp_depth else [])
    assert sorted(gm) == sorted(wm) == sorted(keys)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for key in keys:
        np.testing.assert_allclose(float(gm[key]), float(wm[key]), rtol=1e-5, err_msg=key)


def test_moe_lm_loss_gradients_match_jax_grad(moe_model):
    jcfg, cfg, jp, tp = moe_model
    toks = _tokens(cfg, 8, 11)
    batch = {"tokens": toks, "labels": toks}
    want = jax.grad(lambda p: jx_tf.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                            jcfg)[0])(jp)
    leaves = [p.detach().requires_grad_(True) for p in jax.tree_util.tree_leaves(tp)]
    tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp), leaves)
    loss, _ = tf.lm_loss(tree, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, ref), g in zip(paths, grads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-6 * max(1.0, float(np.abs(ref).max())),
                                   err_msg=jax.tree_util.keystr(path))


def test_moe_init_cache_matches_the_reference(moe_model):
    jcfg, cfg, _, _ = moe_model
    want = jx_tf.init_cache(jcfg, B, 16)
    got = tf.init_cache(cfg, B, 16, device="cpu")
    assert sorted(got) == sorted(want) == ["dense_layers", "layers"]
    for stack in got:
        assert sorted(got[stack]) == sorted(want[stack])
        for key, a in got[stack].items():
            assert tuple(a.shape) == want[stack][key].shape
            assert a.dtype == cfg.adt() and not a.any()


def test_moe_decode_step_matches_the_reference(moe_model):
    """A chunked prefill of 7 tokens at idx 0, then two one-token steps."""
    jcfg, cfg, jp, tp = moe_model
    toks = _tokens(cfg, 9, 12)
    jcache, tcache = jx_tf.init_cache(jcfg, B, 12), tf.init_cache(cfg, B, 12, device="cpu")
    for start, stop in ((0, 7), (7, 8), (8, 9)):
        want, jcache = jx_decode(jp, jcache, jnp.asarray(toks[:, start:stop]),
                                 jnp.int32(start), jcfg)
        got, tcache = tf.decode_step(tp, tcache, torch.from_numpy(toks[:, start:stop]), start,
                                     cfg)
        _close(got, want)
        _close_tree(tcache, jcache)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("batch,prompt_len,new", [(2, 5, 4), (1, 12, 6)])
def test_moe_greedy_generate_gives_the_reference_tokens(arch, batch, prompt_len, new):
    jcfg, cfg = _configs(arch)
    jp, tp = _params(jcfg, seed=1)
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    want = np.asarray(jx_generate(jp, jcfg, jnp.asarray(prompt), new))
    got = generate(tp, cfg, torch.from_numpy(prompt), new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lm_forward_matches_the_reference(model):
    act, jcfg, cfg, jp, tp = model
    S = 9
    toks = _tokens(cfg, S, S)
    fwd = jx_forward
    want, _, want_hidden = fwd(jp, jnp.asarray(toks), jcfg)
    got, aux, hidden = tf.lm_forward(tp, torch.from_numpy(toks), cfg)
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == cfg.adt()
    _close(got, want, act)
    _close(hidden, want_hidden, act)
    assert float(aux) == 0.0


def test_lm_loss_matches_the_reference(model):
    act, jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 12, 4)
    batch = {"tokens": toks, "labels": np.roll(toks, 1, axis=1)}
    loss_fn = jx_loss
    want, wm = loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    got, gm = tf.lm_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    assert sorted(gm) == sorted(wm) == ["moe_aux", "xent"]
    rtol = 1e-5 if act == "float32" else 2e-3
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    np.testing.assert_allclose(float(gm["xent"]), float(wm["xent"]), rtol=rtol)


def test_init_cache_matches_the_reference(model):
    act, jcfg, cfg, _, _ = model
    want = jx_tf.init_cache(jcfg, B, 16)
    got = tf.init_cache(cfg, B, 16, device="cpu")
    for key in ("k", "v"):
        assert tuple(got["layers"][key].shape) == want["layers"][key].shape
        assert got["layers"][key].dtype == cfg.adt() and not got["layers"][key].any()


def test_decode_step_matches_the_reference(model):
    """A chunked prefill of 7 tokens at idx 0, then two one-token steps."""
    act, jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 9, 5)
    step = jx_decode
    jcache, tcache = jx_tf.init_cache(jcfg, B, 12), tf.init_cache(cfg, B, 12, device="cpu")
    for start, stop in ((0, 7), (7, 8), (8, 9)):
        want, jcache = step(jp, jcache, jnp.asarray(toks[:, start:stop]), jnp.int32(start), jcfg)
        got, tcache = tf.decode_step(tp, tcache, torch.from_numpy(toks[:, start:stop]), start,
                                     cfg)
        _close(got, want, act)
        _close_tree(tcache, jcache, act)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch,prompt_len,new", [(2, 5, 4), (1, 12, 6)])
def test_greedy_generate_gives_the_reference_tokens(arch, batch, prompt_len, new):
    jcfg, cfg = _configs(arch)
    jp, tp = _params(jcfg, seed=1)
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    want = np.asarray(jx_generate(jp, jcfg, jnp.asarray(prompt), new))
    got = generate(tp, cfg, torch.from_numpy(prompt), new)
    assert got.dtype == torch.int32 and got.shape == (batch, prompt_len + new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunked_prefill_matches_token_by_token_decode():
    cfg = get_smoke("qwen3-1.7b")
    api = get_api(cfg)
    params = init_params(torch.Generator().manual_seed(2), api.decls(cfg), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 10), generator=torch.Generator().manual_seed(3))
    full = api.prefill(params, {"tokens": toks}, cfg)
    cache = api.init_cache(cfg, 1, 10, device="cpu")
    outs = []
    for i in range(10):
        logits, cache = api.decode_step(params, cache, toks[:, i:i + 1], i, cfg)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(full.numpy(), torch.stack(outs, 1).numpy(), rtol=1e-5, atol=1e-5)
    chunked, _ = api.decode_step(params, api.init_cache(cfg, 1, 10, device="cpu"), toks, 0, cfg)
    np.testing.assert_allclose(full.numpy(), chunked.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients(remat):
    cfg = get_smoke("qwen2-72b")
    api = get_api(cfg)
    params = init_params(torch.Generator().manual_seed(4), api.decls(cfg), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, 8), generator=torch.Generator().manual_seed(5))
    batch = {"tokens": toks, "labels": toks}

    def grads(c):
        leaves = [p.detach().requires_grad_(True) for p in jax.tree_util.tree_leaves(params)]
        tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params), leaves)
        loss, _ = tf.lm_loss(tree, batch, c)
        return torch.autograd.grad(loss, leaves)

    for a, b in zip(grads(cfg), grads(cfg.replace(remat=remat))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_unported_families_name_their_item():
    for arch, item in (("recurrentgemma-2b", "the hybrid family"), ("whisper-medium", "audio"),
                       ("pixtral-12b", "VLM")):
        with pytest.raises(NotImplementedError, match=item):
            get_config(arch)
    base = get_smoke("qwen3-1.7b")
    with pytest.raises(NotImplementedError, match="the hybrid family"):
        tf.lm_decls(base.replace(family="hybrid"))
    with pytest.raises(NotImplementedError, match="audio"):
        get_api(base.replace(family="audio"))


@pytest.mark.parametrize("arch", ARCHS + MOE)
def test_serve_cli_serves_the_dense_family(arch):
    import contextlib
    import io

    from repro_torch.launch import serve

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "8", "--new", "4"])
    lines = out.getvalue().splitlines()
    assert rc == 0 and len(lines) == 3 and "prefill 2x8" in lines[0] and "8 tokens in" in lines[1]
