"""The port's training checkpoints (``repro_torch.checkpoint.checkpoint``)
against the JAX package's, on the CPU: a checkpoint written by either
package restores in the other bit for bit (the same ``ckpt_%08d`` layout,
``manifest.json`` and ``arrays.npz`` keys), and the port's writes are
atomic and asynchronous as the reference's are.
"""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny trees: more threads only contend with the other test workers

import jax  # noqa: E402

from repro.checkpoint.checkpoint import Checkpointer as JxCheckpointer  # noqa: E402
from repro.configs import get_smoke as jx_get_smoke  # noqa: E402
from repro.models import get_api as jx_get_api  # noqa: E402
from repro.models.params import init_params as jx_init_params  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.checkpoint import checkpoint as ck  # noqa: E402
from repro_torch.checkpoint.checkpoint import Checkpointer  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402


def _train_trees(seed=0, compress=False):
    """The trainer's checkpointed tree ``{"params", "state"}`` in both
    packages, the same values, the AdamW moments and step set."""
    jcfg = jx_get_smoke("qwen2-72b")
    jp = jx_init_params(jax.random.PRNGKey(seed), jx_get_api(jcfg).decls(jcfg))
    jstate = jts.init_train_state(jcfg, jopt.AdamW(), jp, compress=compress)
    rng = np.random.default_rng(seed)
    jstate = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape).astype(np.float32) if a.dtype == np.float32
                   else np.asarray(a) + 7), jstate)
    jtree = {"params": jp, "state": jstate}
    ttree = params_from_reference(jax.tree_util.tree_map(np.asarray, jtree), device="cpu")
    return jtree, ttree


def _same_bits(port_tree, jax_tree):
    want = jax.tree_util.tree_leaves(jax_tree)
    got = tree_leaves(port_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.from_numpy(w).dtype and tuple(g.shape) == w.shape
        assert g.numpy().tobytes() == w.tobytes()


def _zeroed(tree):
    return tree_map(torch.zeros_like, tree)


@pytest.mark.parametrize("compress", [False, True], ids=["adamw", "adamw+ef"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, compress):
    jtree, ttree = _train_trees(1, compress)
    JxCheckpointer(str(tmp_path)).save(12, jtree, metadata={"run": "a"}, block=True)
    got, manifest = Checkpointer(str(tmp_path)).restore(12, _zeroed(ttree))
    assert manifest["step"] == 12 and manifest["metadata"] == {"run": "a"}
    _same_bits(got, jtree)
    assert got["state"]["opt"]["step"].dtype == torch.int32


def test_port_checkpoint_restores_in_jax(tmp_path):
    jtree, ttree = _train_trees(2)
    Checkpointer(str(tmp_path)).save(5, ttree, metadata={"grant": 64}, block=True)
    target = jax.tree_util.tree_map(np.zeros_like, jtree)
    got, manifest = JxCheckpointer(str(tmp_path)).restore(5, target)
    assert manifest["metadata"] == {"grant": 64}
    _same_bits(ttree, got)


def test_manifest_and_keys_are_the_reference_ones(tmp_path):
    jtree, ttree = _train_trees(3)
    JxCheckpointer(str(tmp_path / "jax")).save(3, jtree, block=True)
    Checkpointer(str(tmp_path / "port")).save(3, ttree, block=True)
    manifests = [json.loads((tmp_path / side / "ckpt_00000003" / "manifest.json").read_text())
                 for side in ("jax", "port")]
    assert manifests[0] == manifests[1]
    keys = [sorted(np.load(tmp_path / side / "ckpt_00000003" / "arrays.npz").files)
            for side in ("jax", "port")]
    assert keys[0] == keys[1] and "state/opt/m/layers/attn/bq" in keys[0]


def test_the_trainer_state_round_trips_and_trains_on(tmp_path):
    """An AdamW state restored from a checkpoint gives the same next step
    as the state it was saved from."""
    _, ttree = _train_trees(4)
    from repro_torch.configs import get_smoke

    cfg = get_smoke("qwen2-72b")
    adamw = opt.AdamW(lr=1e-3)
    state = ts.init_train_state(cfg, adamw, ttree["params"])
    c = Checkpointer(str(tmp_path))
    c.save(0, {"params": ttree["params"], "state": state}, block=True)
    restored, _ = c.restore_latest({"params": _zeroed(ttree["params"]), "state": _zeroed(state)})
    step = ts.make_train_step(cfg, adamw)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "labels": tokens}
    a = step(tree_map(torch.clone, ttree["params"]), tree_map(torch.clone, state), batch)
    b = step(restored["params"], restored["state"], batch)
    for x, y in zip(tree_leaves(a[0]), tree_leaves(b[0])):
        assert torch.equal(x, y)


def test_writes_go_to_tmp_then_replace(tmp_path, monkeypatch):
    seen = []
    real = os.replace

    def spy(src, dst):
        seen.append((os.path.basename(src), os.path.basename(dst), sorted(os.listdir(src))))
        return real(src, dst)

    monkeypatch.setattr(ck.os, "replace", spy)
    c = Checkpointer(str(tmp_path))
    c.save(7, {"w": torch.arange(4.0)}, block=True)
    c.save(7, {"w": torch.arange(4.0) + 1}, block=True)  # the same step again: replaced whole
    assert seen == [(".tmp.7", "ckpt_00000007", ["arrays.npz", "manifest.json"])] * 2
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000007"]
    got, _ = c.restore(7, {"w": torch.zeros(4)})
    assert torch.equal(got["w"], torch.arange(4.0) + 1)


def test_latest_step(tmp_path):
    c = Checkpointer(str(tmp_path))
    assert c.latest_step() is None and c.restore_latest({"w": torch.zeros(1)}) == (None, None)
    for step in (3, 120, 9):
        c.save(step, {"w": torch.full((2,), float(step))}, block=True)
    os.makedirs(tmp_path / ".tmp.500")  # a write that never finished is no checkpoint
    os.makedirs(tmp_path / "ckpt_abc")
    assert c.latest_step() == 120
    got, manifest = c.restore_latest({"w": torch.zeros(2)})
    assert manifest["step"] == 120 and got["w"].tolist() == [120.0, 120.0]


def test_save_returns_before_the_write_and_wait_joins_it(tmp_path, monkeypatch):
    release = threading.Event()
    real = np.savez

    def slow(*args, **kwargs):
        assert release.wait(timeout=30)
        return real(*args, **kwargs)

    monkeypatch.setattr(ck.np, "savez", slow)
    c = Checkpointer(str(tmp_path))
    w = torch.arange(3.0)
    c.save(1, {"w": w})
    w.add_(100)  # the host copy was taken at save time
    assert c.latest_step() is None  # still writing
    release.set()
    c.wait()
    assert c.latest_step() == 1
    got, _ = c.restore(1, {"w": torch.zeros(3)})
    assert got["w"].tolist() == [0.0, 1.0, 2.0]


def test_restore_casts_to_the_target_leaf(tmp_path):
    c = Checkpointer(str(tmp_path))
    c.save(0, {"a": torch.arange(3, dtype=torch.float32), "b": [torch.ones(2, dtype=torch.int32)]},
           block=True)
    got, _ = c.restore(0, {"a": torch.zeros(3, dtype=torch.float64),
                           "b": [torch.zeros(2, dtype=torch.int64)]})
    assert got["a"].dtype == torch.float64 and got["b"][0].dtype == torch.int64
    assert got["a"].tolist() == [0.0, 1.0, 2.0] and got["b"][0].tolist() == [1, 1]
    with pytest.raises(TypeError, match="bfloat16"):
        c.save(1, {"a": torch.zeros(2, dtype=torch.bfloat16)})
