"""The port's training stack (``repro_torch.train``, ``repro_torch.data``)
against the JAX package, on the CPU, with the same weights, gradients and
batches.

Tolerances (float32): rtol = 1e-5 on losses, rtol = 1e-4 and atol = 1e-6
on gradients and gradient norms (the same float32 expressions summed in
different orders; a gradient sums more terms than a loss).  An optimizer
update from the same gradients: rtol = 1e-5 with atol 1e-7 on the
parameters, 1e-8 on AdamW's first and 1e-9 on its second moments (a few
ulps of the moments' scale: XLA may fuse ``b·m + (1 − b)·g`` into one FMA).
Error feedback: rtol = atol = 1e-6 (an ulp of the gradients' scale); the
int8 codes of one quantization are exact.  Train steps: rtol = 1e-4 and
atol = 1e-5 (1% of the learning rate) on the parameters, since Adam's
normalised step amplifies an ulp of difference in a gradient near zero;
with compression, a code whose value lies within an ulp of a rounding
boundary may round the other way, so the gradient norm is held to rtol 1e-3
and the parameters to at most 1% of them apart by more than 1e-5, none by
more than the learning rate a step.  ``SyntheticLM`` and ``MemmapLM``
batches are exact.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny model: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from repro.configs import get_smoke as jx_get_smoke  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import get_api as jx_get_api  # noqa: E402
from repro.models import transformer as jx_tf  # noqa: E402
from repro.models.params import init_params as jx_init_params  # noqa: E402
from repro.sharding import shard_map  # noqa: E402
from repro.train import grad_compress as jgc  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import grad_compress as gc  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

ARCHS = ["qwen3-1.7b", "qwen2-72b", "minitron-8b"]
SRC = Path(__file__).resolve().parents[1] / "src"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(arch="qwen3-1.7b", seed=0):
    jcfg, cfg = jx_get_smoke(arch), get_smoke(arch)
    jp = jx_init_params(jax.random.PRNGKey(seed), jx_get_api(jcfg).decls(jcfg))
    return jcfg, cfg, jp, params_from_reference(_np_tree(jp), device="cpu")


def _batch(cfg, batch=4, seq=12, step=0):
    b = data.SyntheticLM(cfg, batch, seq, seed=1)(step)
    return {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v) for k, v in b.items()}


def _close_tree(port, ref, rtol, atol):
    want = jax.tree_util.tree_leaves(ref)
    got = tree_leaves(port)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol, atol=atol)


def _grads(cfg, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    loss, _ = tf.lm_loss(tree_map(lambda _: next(it), params), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss, tree_map(lambda _: next(it), params)


def _random_grads(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    g = jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32), _np_tree(params))
    return jax.tree_util.tree_map(jnp.asarray, g), params_from_reference(g, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradients_match_jax_grad(arch):
    jcfg, cfg, jp, tp = _setup(arch)
    jb, tb = _batch(cfg)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p, b: jx_tf.lm_loss(p, b, jcfg)[0]))(jp, jb)
    loss, got = _grads(cfg, tp, tb)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    _close_tree(got, want, 1e-4, 1e-6)


@pytest.mark.parametrize("max_grad_norm,scale", [(1.0, 1.0), (None, 1.0), (1.0, 1e-3)],
                         ids=["clipped", "unclipped", "under-the-clip"])
def test_adamw_update_matches_the_reference(max_grad_norm, scale):
    _, _, jp, tp = _setup()
    jo, to = jopt.AdamW(max_grad_norm=max_grad_norm), opt.AdamW(max_grad_norm=max_grad_norm)
    js, tstate = jo.init(jp), to.init(tp)
    for step in range(2):  # the second step reads the moments the first wrote
        jg, tg = _random_grads(jp, step, scale)
        jp, js, jm = jax.jit(jo.update)(jg, js, jp)
        tp, tstate, tm = to.update(tg, tstate, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        _close_tree(tp, jp, 1e-5, 1e-7)
        _close_tree(tstate["m"], js["m"], 1e-5, 1e-8)
        _close_tree(tstate["v"], js["v"], 1e-5, 1e-9)
        assert int(tstate["step"]) == int(js["step"]) == step + 1
        assert tstate["step"].dtype == torch.int32


def test_adafactor_update_matches_the_reference():
    _, _, jp, tp = _setup("qwen2-72b")
    jo, to = jopt.Adafactor(weight_decay=0.01), opt.Adafactor(weight_decay=0.01)
    js, tstate = jo.init(jp), to.init(tp)
    assert sorted(tstate["v"]["layers"]["mlp"]["wg"]) == ["vc", "vr"]
    assert sorted(tstate["v"]["final_ln"]) == ["v"]
    for step in range(2):
        jg, tg = _random_grads(jp, 10 + step)
        jp, js, jm = jax.jit(jo.update)(jg, js, jp)
        tp, tstate, tm = to.update(tg, tstate, tp)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        _close_tree(tp, jp, 1e-5, 1e-7)
        _close_tree(tstate["v"], js["v"], 1e-5, 1e-12)


def test_global_norm_matches_the_reference():
    _, _, jp, _ = _setup()
    jg, tg = _random_grads(jp, 3)
    np.testing.assert_allclose(float(opt.global_norm(tg)), float(jopt.global_norm(jg)),
                               rtol=1e-6)


def test_error_feedback_matches_the_reference():
    _, _, jp, tp = _setup()
    jef, tef = jgc.init_error_feedback(jp), gc.init_error_feedback(tp)
    for step in range(2):  # the second step adds the carried residual
        jg, tg = _random_grads(jp, 20 + step)
        jq, jef = jax.jit(jgc.apply_error_feedback)(jg, jef)
        tq, tef = gc.apply_error_feedback(tg, tef)
        _close_tree(tq, jq, 1e-6, 1e-6)
        _close_tree(tef, jef, 1e-6, 1e-6)
    x = _random_grads(jp, 30)[1]["layers"]["mlp"]["wd"]
    q, scale = gc._quantize(x)
    jq, jscale = jgc._quantize(jnp.asarray(x.numpy()))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)


def test_compressed_psum_without_a_group_is_the_round_trip():
    x = np.random.default_rng(5).normal(size=(7, 33)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("pod",))
    want = shard_map(lambda a: jgc.compressed_psum(a, "pod"), mesh=mesh, in_specs=P(),
                     out_specs=P(), check_vma=False)(jnp.asarray(x))
    got = gc.compressed_psum(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


_PSUM_RANK = """
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch.train.grad_compress import compressed_psum
rank, path = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(path, 2), world_size=2, rank=rank)
x = np.random.default_rng(rank).normal(size=(5, 9)).astype(np.float32) * (rank + 1)
out = compressed_psum(torch.from_numpy(x))
np.save(f"{path}.{rank}.npy", out.numpy())
dist.destroy_process_group()
"""


def test_compressed_psum_sums_int8_over_a_gloo_group(tmp_path):
    store = str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _PSUM_RANK, str(r), store], env=env)
             for r in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    xs = [np.random.default_rng(r).normal(size=(5, 9)).astype(np.float32) * (r + 1)
          for r in range(2)]
    scale = np.float32(max(np.abs(x).max() for x in xs) / np.float32(127.0))
    q = sum(np.clip(np.round(x / scale), -127, 127).astype(np.int32) for x in xs)
    for r in range(2):
        np.testing.assert_allclose(np.load(f"{store}.{r}.npy"), q.astype(np.float32) * scale,
                                   rtol=1e-6)


@pytest.mark.parametrize("compress,steps", [(False, 5), (True, 2)], ids=["plain", "compressed"])
def test_train_steps_match_the_reference(compress, steps):
    """Five plain steps; two compressed ones (a code that rounds the other
    way changes every later gradient a little, and with them more codes)."""
    jcfg, cfg, jp, tp = _setup()
    jo, to = jopt.AdamW(lr=1e-3), opt.AdamW(lr=1e-3)
    jstep = jax.jit(jts.make_train_step(jcfg, jo, compress=compress))
    tstep = ts.make_train_step(cfg, to, compress=compress)
    js = jts.init_train_state(jcfg, jo, jp, compress=compress)
    tstate = ts.init_train_state(cfg, to, tp, compress=compress)
    assert sorted(tstate) == sorted(js)
    for step in range(steps):
        jb, tb = _batch(cfg, step=step)
        jp, js, jm = jstep(jp, js, jb)
        tp, tstate, tm = tstep(tp, tstate, tb)
        assert sorted(tm) == sorted(jm) == ["grad_norm", "loss", "moe_aux", "xent"]
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-3 if compress else 1e-4)
    if not compress:
        _close_tree(tp, jp, 1e-4, 1e-5)
        return
    # a code that rounded the other way moves its parameter by at most the
    # learning rate a step: few do, and none by more
    apart = total = 0
    for g, w in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        diff = np.abs(g.numpy() - np.asarray(w))
        assert diff.max() <= steps * 1e-3 * 1.01
        apart += int((diff > 1e-5).sum())
        total += diff.size
    assert apart <= 0.01 * total


def test_grad_accumulation_matches_the_reference_and_one_microbatch():
    jcfg, cfg, jp, tp = _setup("minitron-8b")
    jb, tb = _batch(cfg, batch=4)
    jo, to = jopt.AdamW(lr=1e-3), opt.AdamW(lr=1e-3)
    jp2, _, jm = jax.jit(jts.make_train_step(jcfg, jo, grad_accum=2))(
        jp, jts.init_train_state(jcfg, jo, jp), jb)
    tp2, _, tm = ts.make_train_step(cfg, to, grad_accum=2)(
        tree_map(torch.clone, tp), ts.init_train_state(cfg, to, tp), tb)
    assert sorted(tm) == sorted(jm) == ["grad_norm", "loss"]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    _close_tree(tp2, jp2, 1e-4, 1e-5)
    # two equal microbatches of a mean loss: the full batch's gradient
    _, full = _grads(cfg, tp, tb)
    halves = [_grads(cfg, tp, {k: v[i * 2:(i + 1) * 2] for k, v in tb.items()})[1]
              for i in range(2)]
    for f, a, b in zip(tree_leaves(full), *map(tree_leaves, halves)):
        np.testing.assert_allclose(((a + b) / 2).numpy(), f.numpy(), rtol=1e-4, atol=1e-7)
    with pytest.raises(ValueError, match="microbatches"):
        ts.make_train_step(cfg, to, grad_accum=3)(tp, ts.init_train_state(cfg, to, tp), tb)


@pytest.mark.parametrize("step,shard,num_shards", [(0, 0, 1), (1, 0, 1), (7, 1, 2), (123, 3, 4)])
def test_synthetic_lm_batches_are_the_reference_bits(step, shard, num_shards):
    for arch in ("qwen3-1.7b", "rwkv6-7b"):
        cfg, jcfg = get_smoke(arch), jx_get_smoke(arch)
        got = data.SyntheticLM(cfg, 8, 16, seed=3)(step, shard, num_shards)
        want = jdata.SyntheticLM(jcfg, 8, 16, seed=3)(step, shard, num_shards)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for key in got:
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key])


def test_memmap_lm_batches_are_the_reference_bits(tmp_path):
    path = str(tmp_path / "corpus.bin")
    np.random.default_rng(0).integers(0, 512, 10_000).astype(np.int32).tofile(path)
    cfg, jcfg = get_smoke("qwen3-1.7b"), jx_get_smoke("qwen3-1.7b")
    got_pipe = data.MemmapLM(path, cfg, 6, 31, seed=2)
    want_pipe = jdata.MemmapLM(path, jcfg, 6, 31, seed=2)
    for step, shard, n in ((0, 0, 1), (40, 1, 2), (55, 0, 3)):  # 55 · 6 windows: a new epoch
        got, want = got_pipe(step, shard, n), want_pipe(step, shard, n)
        for key in ("tokens", "labels"):
            assert np.array_equal(got[key], want[key])
    with pytest.raises(ValueError, match="shorter than one window"):
        data.MemmapLM(path, cfg, 1, 20_000)
