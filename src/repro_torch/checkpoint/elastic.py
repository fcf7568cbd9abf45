"""Elastic re-sharding: move a job's state onto a different mesh (the port of
``repro.checkpoint.elastic``).

Used when the market re-provisions a job between auction epochs (more or
fewer chips, a new (data, model) factorisation) and when the supervisor
restarts after losing devices.  The checkpoint holds whole host arrays;
this module computes the new layouts (``sharding.NamedSharding``) and
places the state on them.
"""
from __future__ import annotations

from torch.distributed.tensor import DTensor

from ..models import ModelConfig, get_api
from ..models.params import tree_map, validated_pspec_tree
from ..sharding.specs import NamedSharding, distribute_local, placements


def param_shardings(cfg: ModelConfig, mesh, rules=None):
    """A ``NamedSharding`` a parameter: ``validated_pspec_tree`` on ``mesh``."""
    decls = get_api(cfg).decls(cfg)
    return tree_map(lambda d, spec: NamedSharding(mesh, spec), decls,
                    validated_pspec_tree(decls, mesh, rules))


def train_state_shardings(cfg: ModelConfig, mesh, rules=None) -> dict:
    """The layout of a ``{"params", "state"}`` train state (``launch.train``'s
    checkpoint): AdamW's moments laid out as their parameters, as the
    trainer places them; the step count and anything else whole."""
    params = param_shardings(cfg, mesh, rules)
    return {"params": params, "state": {"opt": {"m": params, "v": params}}}


def reshard(tree, shardings):
    """Every leaf placed as its ``NamedSharding`` says: a redistribution
    within one mesh, through the whole array (gathered by the old mesh's
    ranks) across meshes; on a mesh of one rank, the whole tensor."""

    def per_leaf(x, sh: NamedSharding):
        if isinstance(x, DTensor) and x.device_mesh == sh.mesh:
            return x.redistribute(sh.mesh, placements(sh.spec, sh.mesh))
        whole = x.full_tensor() if isinstance(x, DTensor) else x
        if sh.mesh.size() == 1:
            return whole
        return distribute_local(whole, sh.mesh, sh.spec)

    return tree_map(per_leaf, tree, shardings)


def elastic_restore(checkpointer, cfg: ModelConfig, mesh, target_tree, rules=None):
    """Restore the latest checkpoint onto ``mesh`` (any shape): a parameter
    tree, or a ``{"params", "state"}`` train state (:func:`train_state_shardings`)."""
    if isinstance(target_tree, dict) and {"params", "state"} <= target_tree.keys():
        return checkpointer.restore_latest(target_tree, train_state_shardings(cfg, mesh, rules))
    return checkpointer.restore_latest(target_tree, param_shardings(cfg, mesh, rules))
