"""An economy's mutable state as a tree of numpy arrays (the counterpart of
a model's weights).

The keys are exactly those the reference's ``MarketCheckpointer`` writes:
``pop/<field>`` for every population field, ``capacity``, ``usage``,
``belief``, ``base_cost_rt``, ``pool_reliability``, ``price_history``, and,
when present, the epoch-to-epoch carry arrays.  The bid RNG's PCG64 state
travels beside the tree.  A JAX economy's state therefore loads into a port
economy as plain arrays, and both settle the next epochs identically.
"""
from __future__ import annotations

import numpy as np

from .economy import _POP_FIELDS, AgentPopulation, Economy

# epoch-to-epoch carry arrays, present in the tree only when set
OPTIONAL = ("_last_reserve", "_last_filled", "_last_cap_eff", "_reach_keys")


def economy_state(eco) -> tuple[dict[str, np.ndarray], dict]:
    """``(tree, rng_state)`` of an economy — this package's or any object
    with the reference economy's attributes.  A fused economy first brings
    its device state back into the host mirrors the tree reads."""
    sync = getattr(eco, "sync_host_mirrors", None)
    if sync is not None:
        sync()
    tree = {f"pop/{f}": np.asarray(getattr(eco.pop, f)) for f in _POP_FIELDS}
    tree.update(
        capacity=np.asarray(eco.capacity),
        usage=np.asarray(eco.usage),
        belief=np.asarray(eco.belief),
        base_cost_rt=np.asarray(eco.base_cost_rt),
        pool_reliability=np.asarray(eco.pool_reliability),
        price_history=(
            np.stack(eco.price_history) if eco.price_history
            else np.zeros((0, eco.R), np.float32)
        ),
    )
    for name in OPTIONAL:
        val = getattr(eco, name, None)
        if val is not None:
            tree[name] = np.asarray(val)
    return tree, eco.rng.bit_generator.state


def load_economy_state(eco: Economy, tree: dict[str, np.ndarray], rng_state: dict) -> None:
    """Overwrite ``eco``'s mutable state with ``tree`` and the RNG state.

    Build the same economy first (same constructor arguments); every array
    is copied, so the tree's owner keeps its own.
    """
    if tree["capacity"].shape != eco.capacity.shape:
        raise ValueError(
            f"state is for a {tree['capacity'].shape} economy, got {eco.capacity.shape}"
        )
    fields = {f: np.array(tree[f"pop/{f}"]) for f in _POP_FIELDS}
    names = eco.pop.names
    if names is not None and len(names) != len(fields["value"]):
        names = None
    eco.pop = AgentPopulation(names=names, **fields)
    eco.capacity = np.array(tree["capacity"])
    eco.usage = np.array(tree["usage"])
    eco.belief = np.array(tree["belief"])
    eco.base_cost_rt = np.array(tree["base_cost_rt"])
    eco.pool_reliability = np.array(tree["pool_reliability"])
    eco.price_history = [np.array(row) for row in tree["price_history"]]
    for name in OPTIONAL:
        val = tree.get(name)
        setattr(eco, name, None if val is None else np.array(val))
    eco.rng = np.random.default_rng()
    eco.rng.bit_generator.state = rng_state
    eco.invalidate_device_state()  # a fused economy uploads the loaded state
