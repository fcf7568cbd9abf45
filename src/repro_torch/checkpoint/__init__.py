"""Durable state of the port's market: the shared atomic record store
(:mod:`.store`), economy checkpoints at epoch boundaries (:mod:`.market`)
and the always-on service's full and dirty-row delta records at tick
boundaries (:mod:`.service`).  Records are the reference's
(``repro.checkpoint``), so either package restores the other's."""
from .market import MarketCheckpointer
from .service import ServiceCheckpointer
from .store import CheckpointStore

__all__ = ["CheckpointStore", "MarketCheckpointer", "ServiceCheckpointer"]
