"""Serving layer of the port: the always-on market service (:mod:`.market`,
with its write-ahead log :mod:`.wal` and :class:`ServiceConfig`) and batched
generation (:mod:`.decode`)."""
from .config import ServiceConfig
from .market import BidDelta, MarketService, ServiceHealth
from .wal import WriteAheadLog

__all__ = ["BidDelta", "MarketService", "ServiceConfig", "ServiceHealth", "WriteAheadLog"]
