"""The port's layout rules (``repro_torch.sharding``, ``models.params``,
``train.optimizer`` ZeRO-1, ``launch.mesh``) against the JAX package's.

Spec trees are compared leaf for leaf as tuples for every arch's full
config at meshes 1×1, 2×4, 4×16, 16×16 and 2×16×16.  Neither side needs
devices: the reference's rules read only ``mesh.axis_names`` and
``mesh.devices.shape`` (a stand-in, as ``tests/test_sharding.py`` uses), the
port's only the mesh's names and sizes (``launch.mesh.AbstractMesh``).  The
activation hints are held to the spec the reference hands
``with_sharding_constraint`` (captured) on the shapes of the sharding
script in ``tests/test_dryrun_specs.py`` and more.  No tolerances: specs are
equal or not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.sharding.specs as jspecs  # noqa: E402
from repro.configs import ARCH_IDS, get_config as jx_get_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import get_api as jx_get_api  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.models import get_api  # noqa: E402
from repro_torch.models import params as pparams  # noqa: E402
from repro_torch.sharding import specs as pspecs  # noqa: E402
from repro_torch.train import optimizer as popt  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "2x4": (("data", "model"), (2, 4)),
    "4x16": (("data", "model"), (4, 16)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}


class _RefMesh:
    """The reference's stand-in: axis names and a devices array's shape."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.zeros(shape)


def _meshes(name):
    names, shape = MESHES[name]
    return _RefMesh(names, shape), pmesh.AbstractMesh(names, shape)


def _ref_leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, P))


def _port_leaves(decls, tree):
    out = []
    pparams.tree_map(lambda d, leaf: out.append(leaf), decls, tree)
    return out


def _as_tuple(spec):
    return tuple(spec)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_equal_the_reference(arch, mesh):
    jm, pm = _meshes(mesh)
    jdecls = jx_get_api(jx_get_config(arch)).decls(jx_get_config(arch))
    decls = get_api(get_config(arch)).decls(get_config(arch))
    assert _port_leaves(decls, pparams.pspec_tree(decls)) == [
        _as_tuple(s) for s in _ref_leaves(jparams.pspec_tree(jdecls))]
    jvalid = jparams.validated_pspec_tree(jdecls, jm)
    valid = pparams.validated_pspec_tree(decls, pm)
    assert _port_leaves(decls, valid) == [_as_tuple(s) for s in _ref_leaves(jvalid)]
    axes = jmesh.data_axes(jm)
    assert pmesh.data_axes(pm) == axes
    jz = jopt.zero1_state_specs(jvalid, jparams.abstract_params(jdecls), jm, axes)
    z = popt.zero1_state_specs(valid, pparams.abstract_params(decls), pm, axes)
    assert _port_leaves(decls, z) == [_as_tuple(s) for s in _ref_leaves(jz)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_counts_equal_the_reference(arch):
    jdecls = jx_get_api(jx_get_config(arch)).decls(jx_get_config(arch))
    decls = get_api(get_config(arch)).decls(get_config(arch))
    want = jax.tree_util.tree_leaves(jparams.abstract_params(jdecls))
    got = pparams.tree_leaves(pparams.abstract_params(decls))
    assert [tuple(t.shape) for t in got] == [tuple(s.shape) for s in want]
    assert all(t.dtype == torch.bfloat16 and t.device.type == "meta" for t in got)
    assert all(s.dtype == jax.numpy.bfloat16 for s in want)
    f32 = pparams.tree_leaves(pparams.abstract_params(decls, torch.float32))
    assert all(t.dtype == torch.float32 for t in f32)
    assert pparams.count_params(decls) == jparams.count_params(jdecls)


RULES = {"default": {}, "sp": {"seq": "model"}, "kv_seq": {"kv_seq": "model"},
         "pod_batch": {"batch": ("pod", "data")}}

# (shape, logical axes): the dry-run sharding script's and the models' sites
SHARD_CASES = [
    ((8, 16, 8, 4), ("batch", "seq", "heads", None)),
    ((3, 5), ("batch", "seq")),
    ((8, 16, 64), ("batch", "seq", "act_embed")),
    ((8, 16, 512), ("batch", "seq", "vocab")),
    ((4, 32, 96), ("batch", None, "ff")),
    ((2, 8, 4, 16), ("groups", "experts", "capacity", None)),
    ((2, 64, 64), ("groups", None, None)),
    ((32, 1, 16), ("batch", None, "act_embed")),
    ((16, 8, 16, 16), ("batch", "heads", None, "kv_seq")),
    ((8, 16), ("batch",)),
]
CACHE_KV = [(8, 32, 4, 8), (8, 32, 2, 8), (3, 32, 2, 8), (32, 4096, 8, 128), (1, 7, 3, 4)]
CACHE_LATENT = [(8, 32, 6), (8, 30, 6), (32, 4096, 576), (3, 5, 7)]
LOGITS = [((8, 4, 1, 32), 1, 3, False), ((8, 2, 1, 32), 1, 3, False),
          ((8, 16, 1, 4096), 1, 3, True), ((8, 2, 2, 1, 32), 1, 4, False),
          ((3, 5, 1, 7), 1, 3, True)]
HINT_MESHES = dict(MESHES, **{"4x4": (("data", "model"), (4, 4))})


@pytest.fixture
def captured(monkeypatch):
    """The reference's hints return the spec they constrain to (None when
    they return their input), on the stand-in mesh."""
    monkeypatch.setattr(jspecs.jax.lax, "with_sharding_constraint", lambda x, sh: sh)
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: spec)

    class X:
        def __init__(self, shape):
            self.shape, self.ndim = shape, len(shape)

    def run(fn, shape, *args):
        x = X(shape)
        out = fn(x, *args)
        return None if out is x else _as_tuple(out)

    yield run
    jspecs.set_mesh(None)
    jspecs.set_act_rules(None)
    pspecs.set_act_rules(None)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", HINT_MESHES)
def test_activation_hints_choose_the_reference_specs(captured, mesh, rules):
    names, shape = HINT_MESHES[mesh]
    jm, pm = _RefMesh(names, shape), pmesh.AbstractMesh(names, shape)
    merged = {**jspecs.ACT_RULES, **RULES[rules]}
    assert pspecs.ACT_RULES == jspecs.ACT_RULES
    jspecs.set_mesh(jm)
    jspecs.set_act_rules(merged)
    pspecs.set_act_rules(merged)
    for dims, axes in SHARD_CASES:
        assert pspecs.logical(*axes) == _as_tuple(jspecs.logical(*axes))
        assert pspecs.shard_spec(dims, axes, pm) == captured(jspecs.shard, dims, *axes), \
            (dims, axes)
    for dims in CACHE_KV:
        assert pspecs.cache_kv_spec(dims, pm) == captured(jspecs.shard_cache_kv, dims), dims
    for dims in CACHE_LATENT:
        assert pspecs.cache_latent_spec(dims, pm) == captured(jspecs.shard_cache_latent, dims)
    for dims, heads, seq, prefer in LOGITS:
        assert pspecs.decode_logits_spec(dims, pm, heads, seq, prefer) == captured(
            jspecs.shard_decode_logits, dims, heads, seq, prefer), dims
    assert captured(jspecs.replicate, (8, 8)) == ()


def test_hints_leave_plain_tensors_and_meshless_code_alone():
    x = torch.zeros(8, 16, 4)
    assert pspecs.shard(x, "batch", "seq", None) is x
    cache = torch.zeros(2, 4, 2, 2)
    assert pspecs.shard_cache_kv(cache) is cache
    with pspecs.use_mesh(pmesh.AbstractMesh(("data", "model"), (2, 2))):
        assert pspecs.shard(x, "batch", "seq", None) is x
        assert pspecs.replicate(x) is x
        assert pspecs.get_mesh() is not None
    assert pspecs.get_mesh() is None


@pytest.mark.parametrize("names,sizes,spec,want", [
    (("data", "model"), (2, 4), ("data", None, "model"), [Shard(0), Shard(2)]),
    (("data", "model"), (2, 4), (None, "model"), [Replicate(), Shard(1)]),
    (("data", "model"), (2, 1), ("model", "data"), [Shard(1), Replicate()]),
    (("pod", "data", "model"), (2, 4, 4), (("pod", "data"), "model"),
     [Shard(0), Shard(0), Shard(1)]),
    (("data", "model"), (2, 4), ("pod", None), [Replicate(), Replicate()]),
])
def test_placements_of_a_spec(names, sizes, spec, want):
    mesh = pmesh.AbstractMesh(names, sizes)
    got = pspecs.placements(spec, mesh)
    assert list(got) == want
    assert pspecs.placements(pspecs.spec_of(got, mesh, len(spec)), mesh) == got


def test_a_major_to_minor_tuple_must_follow_the_mesh():
    with pytest.raises(ValueError, match="mesh's order"):
        pspecs.placements((("data", "pod"),), pmesh.AbstractMesh(("pod", "data"), (2, 2)))


def test_production_mesh_needs_its_world():
    assert pmesh.abstract_mesh() == (("data", "model"), (16, 16))
    assert pmesh.abstract_mesh(multi_pod=True).shape == (2, 16, 16)
    assert pmesh.axis_size(pmesh.abstract_mesh(True), "pod", "data") == 32
    with pytest.raises(RuntimeError, match="world of 256 ranks"):
        pmesh.make_production_mesh(device_type="cpu")
