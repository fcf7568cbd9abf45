"""The port's audio family (``repro_torch.models.whisper``, the registry's
audio API, ``SyntheticLM``'s audio batches) against the JAX package at
``whisper-smoke`` (2 encoder and 2 decoder layers, 12 frames), on the CPU,
with the same weights (the reference's ``init_params`` through
``params_from_reference``) and frames and tokens made with numpy.

Tolerances:

* float32: rtol = atol = 1e-5 on encoder outputs, logits and caches,
  rtol = 1e-5 on the loss: the same float32 expressions summed in other
  orders.  Gradients: rtol = 1e-4, atol = 1e-6 · max(1, max|ref|).  Greedy
  tokens are exact.
* bfloat16 activations: rtol = 2e-2 and atol = 2e-2 · max(1, max|ref|) of
  the compared array, the reference run op by op (``jax.disable_jit()``),
  rounding to bf16 after every op as PyTorch does.
* ``SyntheticLM`` batches are the reference's bit for bit (bf16 frames
  after widening: the port's float32 draws rounded to bf16 by torch, the
  reference's by ``ml_dtypes``, both to nearest even).
"""
import contextlib
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
from repro.models import whisper as jx_wh  # noqa: E402
from repro.models.params import count_params as jx_count_params  # noqa: E402
from repro.models.params import init_params as jx_init_params  # noqa: E402
from repro.serve.decode import generate as jx_generate  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.models import get_api, make_batch, whisper  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402
from repro_torch.serve.decode import generate  # noqa: E402
from repro_torch.train.train_step import batch_to_device  # noqa: E402

ARCH = "whisper-medium"
FULL_PARAMS = 757_877_760  # the reference's count_params of the full config
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}  # (rtol, atol at scale 1)
B = 2

jx_encode = jax.jit(jx_wh.encode, static_argnums=(2,))
jx_decode_train = jax.jit(jx_wh.decode_train, static_argnums=(3,))
jx_loss = jax.jit(jx_wh.whisper_loss, static_argnums=(2,))
jx_prefill = jax.jit(jx_wh.whisper_prefill, static_argnums=(3,))
jx_step = jax.jit(jx_wh.whisper_decode_step, static_argnums=(4,))


def _configs(act: str = "float32"):
    jcfg = jx_get_smoke(ARCH).replace(act_dtype=act, scan_layers=act == "float32")
    return jcfg, get_smoke(ARCH).replace(act_dtype=act)


def _params(jcfg, seed=0):
    jp = jx_init_params(jax.random.PRNGKey(seed), jx_get_api(jcfg).decls(jcfg))
    return jp, params_from_reference(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _reference(act):
    """The context the reference runs in: jitted in float32, op by op in
    bfloat16."""
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
    else:
        _close(port, ref, act)


def _frames(cfg, seed, batch=B):
    return np.random.default_rng(seed).normal(
        size=(batch, cfg.encdec.num_frames, cfg.d_model)).astype(np.float32)


def _tokens(cfg, S, seed, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)


def _both(x, act):
    """``x`` as the reference's and the port's input in ``act``."""
    if x.dtype == np.float32:
        return (jnp.asarray(x, jnp.bfloat16 if act == "bfloat16" else jnp.float32),
                torch.from_numpy(x).to(torch.bfloat16 if act == "bfloat16" else torch.float32))
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.fixture(scope="module", params=list(TOL))
def model(request):
    act = request.param
    jcfg, cfg = _configs(act)
    jp, tp = _params(jcfg)
    return act, jcfg, cfg, jp, tp


def test_params_from_reference_carry_the_whisper_tree():
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, seed=3)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jp)
    for path, leaf in leaves:
        node = tp
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), np.asarray(leaf)), jax.tree_util.keystr(path)
    assert sorted(tp) == ["dec_layers", "embed", "enc_layers", "enc_ln", "final_ln"]
    assert sorted(tp["dec_layers"]) == ["attn", "ln1", "ln2", "lnx", "mlp", "xattn"]
    assert tp["enc_layers"]["mlp"]["wi"].shape == (cfg.encdec.encoder_layers, cfg.d_model,
                                                   cfg.d_ff)
    assert count_params(whisper.whisper_decls(cfg)) == sum(np.asarray(x).size for _, x in leaves)


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
    assert get_api(cfg).decls is whisper.whisper_decls
    assert count_params(get_api(cfg).decls(cfg)) == jx_count_params(jx_get_api(jcfg).decls(jcfg))
    assert count_params(whisper.whisper_decls(cfg)) == FULL_PARAMS


@pytest.mark.parametrize("length,d", [(12, 64), (1500, 1024), (7, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_sinusoid_pos_is_the_reference_table_built_once(length, d, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = whisper.sinusoid_pos(length, d, dtype, torch.device("cpu"))
    want = np.asarray(jnp.asarray(jx_wh.sinusoid_pos(length, d, jdt), jnp.float32))
    assert got.dtype == dtype and np.array_equal(got.float().numpy(), want)
    assert whisper.sinusoid_pos(length, d, dtype, torch.device("cpu")) is got


def test_encode_matches_the_reference(model):
    act, jcfg, cfg, jp, tp = model
    jf, tf_ = _both(_frames(cfg, 1), act)
    with _reference(act):
        want = jx_encode(jp, jf, jcfg)
    got = whisper.encode(tp, tf_, cfg)
    assert got.shape == (B, cfg.encdec.num_frames, cfg.d_model) and got.dtype == cfg.adt()
    _close(got, want, act)


def test_decode_train_matches_the_reference(model):
    act, jcfg, cfg, jp, tp = model
    jf, tf_ = _both(_frames(cfg, 2), act)
    jt, tt = _both(_tokens(cfg, 9, 2), act)
    with _reference(act):
        want = jx_decode_train(jp, jt, jx_encode(jp, jf, jcfg), jcfg)
    got = whisper.decode_train(tp, tt, whisper.encode(tp, tf_, cfg), cfg)
    assert got.shape == (B, 9, cfg.vocab_size) and got.dtype == cfg.adt()
    _close(got, want, act)


def test_whisper_loss_matches_the_reference(model):
    act, jcfg, cfg, jp, tp = model
    toks = _tokens(cfg, 10, 3)
    batch = {"frames": _frames(cfg, 3), "tokens": toks, "labels": np.roll(toks, 1, axis=1)}
    jb = {k: _both(v, act)[0] for k, v in batch.items()}
    tb = {k: _both(v, act)[1] for k, v in batch.items()}
    with _reference(act):
        want, wm = jx_loss(jp, jb, jcfg)
    got, gm = get_api(cfg).loss(tp, tb, cfg)
    assert sorted(gm) == sorted(wm) == ["xent"]
    rtol = 1e-5 if act == "float32" else 2e-3
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)


def test_whisper_loss_gradients_match_jax_grad():
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, seed=7)
    toks = _tokens(cfg, 8, 7)
    batch = {"frames": _frames(cfg, 7), "tokens": toks, "labels": toks}
    want = jax.jit(jax.grad(lambda p: jx_wh.whisper_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)[0]))(jp)
    leaves = [p.detach().requires_grad_(True) for p in jax.tree_util.tree_leaves(tp)]
    tree = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp), leaves)
    loss, _ = whisper.whisper_loss(tree, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(paths) == len(grads)
    for (path, ref), g in zip(paths, grads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-6 * max(1.0, float(np.abs(ref).max())),
                                   err_msg=jax.tree_util.keystr(path))


def test_prefill_matches_the_reference(model):
    """The registry's prefill: the encoder, then the teacher-forced decoder."""
    act, jcfg, cfg, jp, tp = model
    frames, toks = _frames(cfg, 4), _tokens(cfg, 6, 4)
    with _reference(act):
        want = jx_get_api(jcfg).prefill(jp, {"frames": _both(frames, act)[0],
                                             "tokens": jnp.asarray(toks)}, jcfg)
    got = get_api(cfg).prefill(tp, {"frames": _both(frames, act)[1],
                                    "tokens": torch.from_numpy(toks)}, cfg)
    _close(got, want, act)


def test_init_cache_matches_the_reference(model):
    act, jcfg, cfg, _, _ = model
    want = jx_wh.whisper_init_cache(jcfg, B, 16)
    got = get_api(cfg).init_cache(cfg, B, 16, device="cpu")
    assert sorted(got) == ["cross", "self"]
    for part in got:
        for key, a in got[part].items():
            assert tuple(a.shape) == want[part][key].shape
            assert a.dtype == cfg.adt() and not a.any()


def test_whisper_prefill_and_decode_steps_match_the_reference(model):
    """``whisper_prefill``'s cross cache, then six one-token steps, each
    step's logits and cache."""
    act, jcfg, cfg, jp, tp = model
    jf, tf_ = _both(_frames(cfg, 5), act)
    toks = _tokens(cfg, 6, 5)
    with _reference(act):
        jcache = jx_prefill(jp, jf, jx_wh.whisper_init_cache(jcfg, B, 8), jcfg)
    tcache = whisper.whisper_prefill(tp, tf_, whisper.whisper_init_cache(cfg, B, 8, "cpu"), cfg)
    _close_tree(tcache, jcache, act)
    for i in range(6):
        with _reference(act):
            want, jcache = jx_step(jp, jcache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i), jcfg)
        idx = i if i % 2 else torch.tensor(i)  # an int and a device tensor
        got, tcache = whisper.whisper_decode_step(tp, tcache, torch.from_numpy(toks[:, i:i + 1]),
                                                  idx, cfg)
        assert got.shape == (B, 1, cfg.vocab_size)
        _close(got, want, act)
        _close_tree(tcache, jcache, act)


@pytest.mark.parametrize("batch,prompt_len,new", [(2, 5, 4), (1, 12, 6)])
def test_greedy_generate_gives_the_reference_tokens(batch, prompt_len, new):
    """Against the zero cross cache of ``init_cache``, as the reference's
    ``generate`` decodes; prompts longer than the 8 the hybrid's window
    holds, warmed token by token."""
    jcfg, cfg = _configs()
    jp, tp = _params(jcfg, seed=1)
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    want = np.asarray(jx_generate(jp, jcfg, jnp.asarray(prompt), new))
    got = generate(tp, cfg, torch.from_numpy(prompt), new)
    assert got.dtype == torch.int32 and got.shape == (batch, prompt_len + new)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("act", list(TOL))
@pytest.mark.parametrize("step,shard,num_shards", [(0, 0, 1), (7, 1, 2)])
def test_synthetic_lm_batches_are_the_reference_bits(act, step, shard, num_shards):
    cfg, jcfg = get_smoke(ARCH).replace(act_dtype=act), jx_get_smoke(ARCH).replace(act_dtype=act)
    got = data.SyntheticLM(cfg, 4, 10, seed=3)(step, shard, num_shards)
    want = jdata.SyntheticLM(jcfg, 4, 10, seed=3)(step, shard, num_shards)
    assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
    on_device = batch_to_device(got, cfg, "cpu")
    for key in got:
        w = np.asarray(want[key])
        if key == "frames":
            assert got[key].dtype == np.float32 and on_device[key].dtype == cfg.adt()
            assert np.array_equal(on_device[key].float().numpy(), w.astype(np.float32))
        else:
            assert got[key].dtype == w.dtype and np.array_equal(got[key], w)
            assert on_device[key].dtype == torch.int32


def test_make_batch_has_the_reference_structure():
    for act in TOL:
        cfg = get_smoke(ARCH).replace(act_dtype=act)
        jcfg = jx_get_smoke(ARCH).replace(act_dtype=act)
        got = make_batch(cfg, 3, 7, torch.Generator().manual_seed(0), device="cpu")
        want = jx_make_batch(jcfg, 3, 7)
        assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
        for key in got:
            assert tuple(got[key].shape) == want[key].shape, key
        assert got["frames"].dtype == cfg.adt()
        assert bool(((got["tokens"] >= 0) & (got["tokens"] < cfg.vocab_size)).all())
        again = make_batch(cfg, 3, 7, torch.Generator().manual_seed(0), device="cpu")
        assert all(torch.equal(got[k], again[k]) for k in got)

