"""Write-ahead log for the always-on market service.

Counterpart of ``repro.serve.wal``, byte for byte: the same magic, framing,
CRC, generation header and torn-tail recovery, so a log written by either
package replays in the other.  Every ``submit`` / ``withdraw`` of
:class:`~repro_torch.serve.market.MarketService` is appended here *before*
the service acknowledges it, so the accepted-delta stream survives any
process death and recovery replays it through the unchanged validation
path.

On-disk format: a fixed 16-byte header followed by framed records::

    b"RMWAL001"                      # magic + format version
    [u64 generation]                 # bumped (and fsync'd) on each compaction
    [u32 length][u32 crc32][payload] # repeated; little-endian, crc of payload

The generation counter disambiguates byte offsets across compactions:
a checkpoint records ``(generation, offset)``, and recovery replays from
that offset only when the generations still match; if the log was
compacted after the checkpoint was cut, every surviving record is newer
than the checkpoint and the whole log replays.

Payloads are pickled tuples (the service logs ``("submit", key, bundles,
pi)`` / ``("withdraw", key)``), but the log itself is payload-agnostic.

Torn tails are expected, not errors: a crash mid-append leaves a partial
frame (short header, short payload, or a CRC mismatch), and
recovery on open truncates the file back to the last intact record
boundary.  Everything before that boundary was acknowledged with the
bytes already handed to the kernel, so the longest-intact-prefix contract
is exactly the acknowledgment contract.

Durability modes (``sync=``):

* ``"flush"`` (default): every append is written and flushed to the
  kernel before the caller acknowledges.  This survives any process
  death (``os._exit``, SIGKILL); it is lost only on kernel panic or power
  failure.
* ``"fsync"``: additionally ``os.fsync`` per append, power-failure durable.
* ``"none"``: buffered writes, flushed only on :meth:`sync`/close.

Whatever the mode, the service calls :meth:`sync` (a real fsync) at every
tick-commit boundary before truncating the log, so committed auction
state is power-durable even under ``"flush"``.
"""
from __future__ import annotations

import os
import pickle
import struct
import zlib

_MAGIC = b"RMWAL001"
_GEN = struct.Struct("<Q")  # compaction generation counter
_HEADER = struct.Struct("<II")  # (payload length, crc32(payload))
_DATA_START = len(_MAGIC) + _GEN.size

_SYNC_MODES = ("none", "flush", "fsync")


class WriteAheadLog:
    """Append-only, CRC-framed journal with torn-tail recovery.

    Opening an existing file runs :meth:`recover` implicitly: the tail is
    truncated back to the last intact record and ``recovered_records`` /
    ``dropped_bytes`` report what survived.  A file whose header is
    missing or wrong is rejected loudly (it is not a WAL) unless it is
    empty, in which case it is (re)initialized.
    """

    def __init__(self, path: str, sync: str = "flush"):
        if sync not in _SYNC_MODES:
            raise ValueError(f"sync must be one of {_SYNC_MODES}, got {sync!r}")
        self.path = path
        self.sync_mode = sync
        self.recovered_records = 0
        self.dropped_bytes = 0
        self.generation = 0
        exists = os.path.exists(path) and os.path.getsize(path) > 0
        self._f = open(path, "r+b" if exists else "w+b")
        if exists:
            self._recover()
        else:
            self._f.write(_MAGIC)
            self._f.write(_GEN.pack(0))
            self._f.flush()
            os.fsync(self._f.fileno())

    # -- write ---------------------------------------------------------------

    def append(self, record) -> int:
        """Frame, write, and (per the sync mode) flush one record.

        Returns the end-of-record byte offset — a valid replay boundary
        for :meth:`records` and the value checkpoints persist so recovery
        replays only the un-checkpointed tail."""
        payload = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
        self._f.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)
        if self.sync_mode != "none":
            self._f.flush()
        if self.sync_mode == "fsync":
            os.fsync(self._f.fileno())
        return self._f.tell()

    def sync(self) -> None:
        """Group commit: flush + fsync everything appended so far."""
        self._f.flush()
        os.fsync(self._f.fileno())

    def reset(self) -> None:
        """Log compaction: drop every record (the checkpoint now owns them).

        Bumps the generation counter so stale checkpoint offsets into the
        pre-compaction log cannot alias records appended afterwards; the
        truncation is fsync'd, so a post-checkpoint crash cannot resurrect
        compacted records."""
        self.generation += 1
        self._f.seek(len(_MAGIC))
        self._f.write(_GEN.pack(self.generation))
        self._f.truncate(_DATA_START)
        self._f.seek(_DATA_START)
        self._f.flush()
        os.fsync(self._f.fileno())

    def truncate_to(self, offset: int) -> int:
        """Prefix compaction: drop bytes ``[data_start, offset)`` — records a
        durable checkpoint now owns — keeping the unconfirmed tail.

        Returns the number of bytes removed; every tracked offset ``>=
        offset`` shifts down by exactly that much (``new = old - removed``).
        The compacted log is built as a sibling file and atomically
        ``os.replace``d in, so a crash at any instant leaves either the old
        log or the new one — never a half-copied tail that torn-frame
        recovery would mistake for the true end of log (losing acknowledged
        records after it).  The generation counter bumps, so checkpoint
        offsets recorded against the old layout replay conservatively from
        ``data_start`` — exactly the surviving, un-checkpointed tail.

        ``offset == end`` degenerates to :meth:`reset` (empty tail);
        ``offset <= data_start`` is a no-op (nothing to drop, no bump).
        """
        end = self._f.tell()
        offset = min(max(int(offset), _DATA_START), end)
        removed = offset - _DATA_START
        if removed <= 0:
            return 0
        if offset == end:
            self.reset()
            return removed
        self._f.seek(offset)
        tail = self._f.read(end - offset)
        tmp = self.path + ".compact"
        with open(tmp, "wb") as g:
            g.write(_MAGIC)
            g.write(_GEN.pack(self.generation + 1))
            g.write(tail)
            g.flush()
            os.fsync(g.fileno())
        os.replace(tmp, self.path)
        self._f.close()
        self.generation += 1
        self._f = open(self.path, "r+b")
        self._f.seek(0, os.SEEK_END)
        return removed

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    @property
    def offset(self) -> int:
        """Current end-of-log byte offset (== next record's start)."""
        return self._f.tell()

    @property
    def data_start(self) -> int:
        """Byte offset of the first record (just past the fixed header)."""
        return _DATA_START

    # -- read ----------------------------------------------------------------

    def records(self, start: int | None = None):
        """Yield ``(record, end_offset)`` from ``start`` (default: begin).

        ``start`` beyond the current end of log (a checkpoint cut just
        before the log was compacted) yields nothing.  Only intact frames
        are yielded; iteration stops at the first torn or corrupt frame —
        callers that want the file physically truncated there use
        :meth:`recover` (done automatically on open)."""
        end = self._f.tell()
        pos = _DATA_START if start is None else max(start, _DATA_START)
        if pos >= end:
            return
        self._f.seek(pos)
        try:
            while pos < end:
                head = self._f.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    break
                length, crc = _HEADER.unpack(head)
                payload = self._f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    break
                pos += _HEADER.size + length
                try:
                    record = pickle.loads(payload)
                except Exception:
                    break  # CRC-clean but unreadable: treat as torn
                yield record, pos
        finally:
            self._f.seek(end)

    # -- recovery ------------------------------------------------------------

    def _recover(self) -> None:
        self._f.seek(0, os.SEEK_END)
        size = self._f.tell()
        self._f.seek(0)
        magic = self._f.read(len(_MAGIC))
        if magic != _MAGIC[: len(magic)]:
            raise ValueError(
                f"{self.path!r} is not a market WAL (bad magic {magic!r})"
            )
        if size < _DATA_START:
            # torn header write on a brand-new log: rewrite it whole
            self._f.seek(0)
            self._f.truncate(0)
            self._f.write(_MAGIC)
            self._f.write(_GEN.pack(0))
            self._f.flush()
            os.fsync(self._f.fileno())
            self.dropped_bytes = size
            return
        (self.generation,) = _GEN.unpack(self._f.read(_GEN.size))
        good = _DATA_START
        count = 0
        while True:
            head = self._f.read(_HEADER.size)
            if len(head) < _HEADER.size:
                break
            length, crc = _HEADER.unpack(head)
            if good + _HEADER.size + length > size:
                break  # frame claims bytes past EOF: torn payload
            payload = self._f.read(length)
            if zlib.crc32(payload) != crc:
                break  # bit flip / torn overwrite
            try:
                pickle.loads(payload)
            except Exception:
                break
            good += _HEADER.size + length
            count += 1
        self.recovered_records = count
        self.dropped_bytes = size - good
        if self.dropped_bytes:
            self._f.truncate(good)
            self._f.flush()
            os.fsync(self._f.fileno())
        self._f.seek(good)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
