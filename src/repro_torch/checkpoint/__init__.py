"""Durable state of the port: training checkpoints (:mod:`.checkpoint`),
the market's shared atomic record store (:mod:`.store`), economy
checkpoints at epoch boundaries (:mod:`.market`) and the always-on
service's full and dirty-row delta records at tick boundaries
(:mod:`.service`).  Records are the reference's (``repro.checkpoint``), so
either package restores the other's."""
from .checkpoint import Checkpointer
from .market import MarketCheckpointer
from .service import ServiceCheckpointer
from .store import CheckpointStore

__all__ = ["Checkpointer", "CheckpointStore", "MarketCheckpointer", "ServiceCheckpointer"]
