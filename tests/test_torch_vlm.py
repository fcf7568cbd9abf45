"""The port's VLM family (``pixtral-12b``: the dense backbone with patch
embeddings in front of the text, ``repro_torch.models.transformer``'s
``image_embeds``, ``SyntheticLM``'s vlm batches) against the JAX package at
``pixtral-12b-smoke`` (2 layers, 8 patches), on the CPU, with the same
weights (the reference's ``init_params`` through ``params_from_reference``)
and patches and tokens made with numpy.

Tolerances:

* float32: rtol = atol = 1e-5 on logits, hidden states and caches, rtol =
  1e-5 on the loss.  Gradients: rtol = 1e-4, atol = 1e-6 · max(1,
  max|ref|).  Greedy tokens are exact.
* bfloat16 activations: rtol = 2e-2 and atol = 2e-2 · max(1, max|ref|) of
  the compared array, rtol = 2e-3 on the loss; the reference runs its
  layers unrolled (``scan_layers=False``) in one jitted program, as in
  ``tests/test_torch_transformer.py``.
* ``SyntheticLM`` batches are the reference's bit for bit (bf16 patches
  after widening: both round to nearest even).
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
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import get_api as jx_get_api  # noqa: E402
from repro.models import make_batch as jx_make_batch  # noqa: E402
from repro.models import transformer as jx_tf  # noqa: E402
from repro.models.params import count_params as jx_count_params  # noqa: E402
from repro.models.params import init_params as jx_init_params  # noqa: E402
from repro.serve.decode import generate as jx_generate  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.models import get_api, make_batch  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402
from repro_torch.serve.decode import generate  # noqa: E402
from repro_torch.train.train_step import batch_to_device  # noqa: E402

ARCH = "pixtral-12b"
FULL_PARAMS = 12_247_782_400  # the reference's count_params of the full config
TRAIN_6_LAYERS = 2_978_022_400  # the full widths cut to 6 layers
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}  # (rtol, atol at scale 1)
B = 2

jx_forward = jax.jit(jx_tf.lm_forward, static_argnums=(2,))
jx_loss = jax.jit(jx_tf.lm_loss, static_argnums=(2,))
jx_decode = jax.jit(jx_tf.decode_step, static_argnums=(4,))


def _configs(act: str = "float32"):
    jcfg = jx_get_smoke(ARCH).replace(act_dtype=act, scan_layers=act == "float32")
    return jcfg, get_smoke(ARCH).replace(act_dtype=act)


def _params(jcfg, seed=0):
    jp = jx_init_params(jax.random.PRNGKey(seed), jx_get_api(jcfg).decls(jcfg))
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


def _tokens(cfg, S, seed, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)


def _patches(cfg, seed, act, batch=B):
    x = np.random.default_rng(seed).normal(
        size=(batch, cfg.vlm_patches, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(x, jnp.bfloat16 if act == "bfloat16" else jnp.float32),
            torch.from_numpy(x).to(torch.bfloat16 if act == "bfloat16" else torch.float32))


@pytest.fixture(scope="module", params=list(TOL))
def model(request):
    act = request.param
    jcfg, cfg = _configs(act)
    jp, tp = _params(jcfg)
    return act, jcfg, cfg, jp, tp


def test_configs_are_the_reference_configs():
    for port, ref in ((get_config(ARCH), jx_get_config(ARCH)),
                      (get_smoke(ARCH), jx_get_smoke(ARCH))):
        for field in dataclasses.fields(ref):
            assert getattr(port, field.name) == getattr(ref, field.name), field.name


def test_full_config_has_the_reference_parameter_count():
    cfg, jcfg = get_config(ARCH), jx_get_config(ARCH)
    assert count_params(tf.lm_decls(cfg)) == jx_count_params(jx_get_api(jcfg).decls(jcfg))
    assert count_params(get_api(cfg).decls(cfg)) == FULL_PARAMS
    assert count_params(tf.lm_decls(cfg.replace(num_layers=6))) == TRAIN_6_LAYERS


def test_params_from_reference_carry_the_vlm_tree():
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, seed=3)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in leaves:
        node = tp
        for key in path:
            node = node[key.key]
        assert np.array_equal(node.numpy(), np.asarray(leaf)), jax.tree_util.keystr(path)
    assert sorted(tp) == ["embed", "final_ln", "head", "layers"]


@pytest.mark.parametrize("with_patches", [True, False], ids=["patches", "text"])
def test_lm_forward_matches_the_reference(model, with_patches):
    act, jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 9, 9)
    jimg, timg = _patches(cfg, 9, act) if with_patches else (None, None)
    want, _, want_hidden = jx_forward(jp, jnp.asarray(toks), jcfg, image_embeds=jimg)
    got, aux, hidden = tf.lm_forward(tp, torch.from_numpy(toks), cfg, image_embeds=timg)
    S = 9 + (cfg.vlm_patches if with_patches else 0)
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == cfg.adt()
    _close(got, want, act)
    _close(hidden, want_hidden, act)
    assert float(aux) == 0.0


def test_lm_loss_drops_the_patch_positions_as_the_reference(model):
    act, jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 10, 4)
    jimg, timg = _patches(cfg, 4, act)
    labels = np.roll(toks, 1, axis=1)
    want, wm = jx_loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                            "image_embeds": jimg}, jcfg)
    got, gm = tf.lm_loss(tp, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels), "image_embeds": timg}, cfg)
    assert sorted(gm) == sorted(wm) == ["moe_aux", "xent"]
    rtol = 1e-5 if act == "float32" else 2e-3
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    # the text alone is another loss: the patches change what the text sees
    text, _ = tf.lm_loss(tp, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels)}, cfg)
    assert float(text) != float(got)


def test_lm_loss_gradients_match_jax_grad():
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, seed=7)
    toks = _tokens(cfg, 8, 7)
    jimg, timg = _patches(cfg, 7, "float32")
    want = jax.jit(jax.grad(lambda p: jx_tf.lm_loss(
        p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks), "image_embeds": jimg},
        jcfg)[0]))(jp)
    leaves = [p.detach().requires_grad_(True) for p in jax.tree_util.tree_leaves(tp)]
    tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp), leaves)
    loss, _ = get_api(cfg).loss(tree, {"tokens": torch.from_numpy(toks),
                                       "labels": torch.from_numpy(toks),
                                       "image_embeds": timg}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, ref), g in zip(paths, grads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-6 * max(1.0, float(np.abs(ref).max())),
                                   err_msg=jax.tree_util.keystr(path))


def test_prefill_with_patches_matches_the_reference(model):
    act, jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 6, 6)
    jimg, timg = _patches(cfg, 6, act)
    want = jx_get_api(jcfg).prefill(jp, {"tokens": jnp.asarray(toks), "image_embeds": jimg},
                                    jcfg)
    got = get_api(cfg).prefill(tp, {"tokens": torch.from_numpy(toks), "image_embeds": timg}, cfg)
    _close(got, want, act)


def test_init_cache_and_decode_step_match_the_reference(model):
    """The dense cache and step: a chunked prefill of 7 tokens at idx 0,
    then two one-token steps."""
    act, jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 9, 5)
    jcache, tcache = jx_tf.init_cache(jcfg, B, 12), tf.init_cache(cfg, B, 12, device="cpu")
    assert sorted(tcache) == sorted(jcache) == ["layers"]
    for key in ("k", "v"):
        assert tuple(tcache["layers"][key].shape) == jcache["layers"][key].shape
    for start, stop in ((0, 7), (7, 8), (8, 9)):
        want, jcache = jx_decode(jp, jcache, jnp.asarray(toks[:, start:stop]),
                                 jnp.int32(start), jcfg)
        got, tcache = tf.decode_step(tp, tcache, torch.from_numpy(toks[:, start:stop]), start,
                                     cfg)
        _close(got, want, act)
        _close_tree(tcache, jcache, act)


@pytest.mark.parametrize("batch,prompt_len,new", [(2, 5, 4), (1, 12, 6)])
def test_greedy_generate_gives_the_reference_tokens(batch, prompt_len, new):
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, seed=1)
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    want = np.asarray(jx_generate(jp, jcfg, jnp.asarray(prompt), new))
    got = generate(tp, cfg, torch.from_numpy(prompt), new)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("act", list(TOL))
@pytest.mark.parametrize("seq", [20, 12])  # text of seq - 8 patches, and the floor of 8
def test_synthetic_lm_batches_are_the_reference_bits(act, seq):
    cfg, jcfg = get_smoke(ARCH).replace(act_dtype=act), jx_get_smoke(ARCH).replace(act_dtype=act)
    for step, shard, n in ((0, 0, 1), (5, 1, 2)):
        got = data.SyntheticLM(cfg, 4, seq, seed=2)(step, shard, n)
        want = jdata.SyntheticLM(jcfg, 4, seq, seed=2)(step, shard, n)
        assert sorted(got) == sorted(want) == ["image_embeds", "labels", "tokens"]
        assert got["tokens"].shape == (4 // n, max(seq - cfg.vlm_patches, 8))
        on_device = batch_to_device(got, cfg, "cpu")
        for key in got:
            w = np.asarray(want[key])
            if key == "image_embeds":
                assert got[key].dtype == np.float32 and on_device[key].dtype == cfg.adt()
                assert np.array_equal(on_device[key].float().numpy(), w.astype(np.float32))
            else:
                assert got[key].dtype == w.dtype and np.array_equal(got[key], w)


def test_make_batch_has_the_reference_structure():
    for seq in (20, 12):
        cfg, jcfg = get_smoke(ARCH), jx_get_smoke(ARCH)
        got = make_batch(cfg, 3, seq, torch.Generator().manual_seed(0), device="cpu")
        want = jx_make_batch(jcfg, 3, seq)
        assert sorted(got) == sorted(want) == ["image_embeds", "labels", "tokens"]
        for key in got:
            assert tuple(got[key].shape) == want[key].shape, key
        assert got["image_embeds"].dtype == cfg.adt()
