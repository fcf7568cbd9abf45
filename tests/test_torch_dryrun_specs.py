"""The port's dry-run specs (``repro_torch.configs.shapes``,
``repro_torch.launch.specs``, the config helpers of
``repro_torch.launch.dryrun``) against the reference's, for every arch.

Neither side needs devices: the reference's layout code reads a mesh's
``axis_names`` and ``devices.shape`` (the stand-in of
``tests/test_torch_sharding.py``; its ``NamedSharding`` is swapped for a
holder of the spec, since JAX's wants a real mesh), the port's a mesh's
names and sizes (``launch.mesh.AbstractMesh``).  Stand-ins are compared by
shape and dtype, layouts as spec tuples leaf for leaf.  No tolerances.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

import repro.launch.specs as jspecs  # noqa: E402
from repro.configs import ARCH_IDS, get_config as jx_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as JX_SHAPES, applicable as jx_applicable  # noqa: E402
from repro.train.optimizer import Adafactor as JAdafactor, AdamW as JAdamW  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable  # noqa: E402
from repro_torch.launch import dryrun as pdryrun  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import specs as pspecs  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.sharding.specs import NamedSharding  # noqa: E402
from repro_torch.train.optimizer import Adafactor, AdamW  # noqa: E402


# The reference's ``repro.launch.dryrun`` sets XLA's host device count when
# it is imported, for whatever process imports it next; its helpers run in a
# subprocess, which prints them as JSON.
REF_SCRIPT = r"""
import json
import numpy as np
from repro.configs import ARCH_IDS, get_config
from repro.configs.shapes import SHAPES
from repro.launch import dryrun as dr
from repro.models import get_api
from repro.models.params import count_params


class Mesh:
    def __init__(self, names, shape):
        self.axis_names, self.devices = names, np.zeros(shape)


def brief(cfg):
    return [cfg.num_layers, cfg.moe and cfg.moe.first_dense_layers,
            cfg.encdec and cfg.encdec.encoder_layers]


out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    segs = dr.segment_counts(cfg)
    probes = [{k: 1 for k in segs}] + [{**{k: 1 for k in segs}, k: 2} for k in segs] + [segs]
    n = count_params(get_api(cfg).decls(cfg))
    out[arch] = {"segments": segs, "n_params": n, "n_active": dr.n_active_params(cfg, n),
                 "probes": [[p, brief(dr.with_segments(cfg, p)),
                             dr.segment_counts(dr.with_segments(cfg, p))] for p in probes],
                 "adjusted": {f"{s}/{m}": [a.remat, a.moe and a.moe.groups] for s in SHAPES
                              for m, (names, shape) in MESHES.items()
                              for a in [dr.adjust_cfg(cfg, SHAPES[s], Mesh(names, shape))]}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT.replace("MESHES", repr(MESHES))],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


class _RefMesh:
    """The reference's stand-in: axis names and a devices array's shape."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.zeros(shape)


class _Sharding:
    """Holds what the reference hands ``NamedSharding``."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec


@pytest.fixture
def ref_shardings(monkeypatch):
    monkeypatch.setattr(jspecs, "NamedSharding", _Sharding)


def _meshes(name):
    names, shape = MESHES[name]
    return _RefMesh(names, shape), pmesh.AbstractMesh(names, shape)


def _ref_specs(tree):
    return [tuple(s.spec) for s in
            jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, _Sharding))]


def _port_specs(tree):
    leaves = tree_leaves(tree)
    assert all(isinstance(x, NamedSharding) for x in leaves)
    return [x.spec for x in leaves]


def _same_stand_ins(ref_tree, port_tree):
    ref = jax.tree_util.tree_leaves(ref_tree)
    port = tree_leaves(port_tree)
    assert [tuple(x.shape) for x in port] == [tuple(x.shape) for x in ref]
    assert [str(x.dtype).removeprefix("torch.") for x in port] == \
        [jnp.dtype(x.dtype).name for x in ref]


def test_shapes_equal_the_reference():
    assert list(SHAPES) == list(JX_SHAPES)
    for name, s in SHAPES.items():
        j = JX_SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)
    assert ShapeSpec("x", 1, 2, "train") == ShapeSpec("x", 1, 2, "train")  # frozen, hashable


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicable_equals_the_reference(arch):
    for name in SHAPES:
        assert applicable(get_config(arch), SHAPES[name]) == \
            jx_applicable(jx_get_config(arch), JX_SHAPES[name])


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch, shape):
    want = jspecs.input_specs(jx_get_config(arch), JX_SHAPES[shape])
    with FakeTensorMode():
        got = pspecs.input_specs(get_config(arch), SHAPES[shape])
    assert list(got) == list(want)
    for k in want:
        _same_stand_ins(want[k], got[k])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_shardings_equal_the_reference(arch, mesh, ref_shardings):
    jm, pm = _meshes(mesh)
    jcfg, cfg = jx_get_config(arch), get_config(arch)
    for shape in SHAPES:
        want = jspecs.batch_shardings(jcfg, JX_SHAPES[shape], jm)
        got = pspecs.batch_shardings(cfg, SHAPES[shape], pm)
        assert list(got) == list(want)
        assert [got[k].spec for k in got] == [tuple(want[k].spec) for k in want]
    for shape in ("decode_32k", "long_500k"):
        s = JX_SHAPES[shape]
        api = jspecs.get_api(jcfg)
        jcache = jax.eval_shape(lambda: api.init_cache(jcfg, s.global_batch, s.seq_len))
        with FakeTensorMode():
            pcache = pspecs.get_api(cfg).init_cache(cfg, s.global_batch, s.seq_len, device="cpu")
        _same_stand_ins(jcache, pcache)
        assert _port_specs(pspecs.cache_shardings(cfg, pcache, pm)) == \
            _ref_specs(jspecs.cache_shardings(jcfg, jcache, jm))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_cell_equals_the_reference(arch, mesh, ref_shardings):
    """Every shape's stand-ins and layouts: parameters (FSDP rules for
    training, resident weights for serving), batch, and the optimizer state
    (AdamW; Adafactor for ``moe``, whose factored moments drop the ZeRO-1
    entries that no longer divide) or the decode cache and index."""
    jm, pm = _meshes(mesh)
    jcfg, cfg = jx_get_config(arch), get_config(arch)
    for shape in SHAPES:
        kind = SHAPES[shape].kind
        moe = cfg.family == "moe"
        jopt = (JAdafactor() if moe else JAdamW()) if kind == "train" else None
        popt = (Adafactor() if moe else AdamW()) if kind == "train" else None
        want = jspecs.build_cell(jcfg, JX_SHAPES[shape], jm, optimizer=jopt)
        got = pspecs.build_cell(cfg, SHAPES[shape], pm, optimizer=popt)
        _same_stand_ins(want.params_abs, got.params_abs)
        assert _port_specs(got.params_sh) == _ref_specs(want.params_sh)
        _same_stand_ins(want.batch_abs, got.batch_abs)
        assert _port_specs(got.batch_sh) == _ref_specs(want.batch_sh)
        assert len(got.extra_abs) == len(want.extra_abs) == len(got.extra_sh)
        for w_abs, g_abs, w_sh, g_sh in zip(want.extra_abs, got.extra_abs, want.extra_sh,
                                            got.extra_sh):
            _same_stand_ins(w_abs, g_abs)
            assert _port_specs(g_sh) == _ref_specs(w_sh)


def _brief(cfg):
    return [cfg.num_layers, cfg.moe and cfg.moe.first_dense_layers,
            cfg.encdec and cfg.encdec.encoder_layers]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_depth_helpers_equal_the_reference(arch, reference):
    ref = reference[arch]
    cfg = get_config(arch)
    assert pdryrun.segment_counts(cfg) == ref["segments"]
    for counts, brief, segs in ref["probes"]:
        got = pdryrun.with_segments(cfg, counts)
        assert _brief(got) == brief and pdryrun.segment_counts(got) == segs
    n = pdryrun.count_params(pspecs.get_api(cfg).decls(cfg))
    assert (n, pdryrun.n_active_params(cfg, n)) == (ref["n_params"], ref["n_active"])


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_adjust_cfg_equals_the_reference(arch, shape, reference):
    cfg = get_config(arch)
    for mesh in MESHES:
        got = pdryrun.adjust_cfg(cfg, SHAPES[shape], _meshes(mesh)[1])
        assert [got.remat, got.moe and got.moe.groups] == \
            reference[arch]["adjusted"][f"{shape}/{mesh}"]
