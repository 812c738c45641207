"""Fault-tolerant sketch serving (``repro.serve.resilience``, DESIGN.md
§16 of the reference): durability, degraded-mode reads with quantified
coverage, and the guarded shard fan-out.

Coordinated sampling degrades gracefully: a sharded corpus is a flat
union of per-partition samples, so losing a shard leaves an unbiased
estimator over the surviving sub-corpus whose Theorem 1/3 error bound is
computable from O(1) per-shard state.  Four pillars:

1. **Durability**: versioned, checksummed snapshots of the bucketized
   host blocks (:func:`save_snapshot` / :func:`load_snapshot`, the
   reference's on-disk format, so a snapshot written by either package
   loads in the other) and a write-ahead ingest journal
   (:class:`IngestJournal`, the reference's line format); a crashed index
   recovers bit-exactly as snapshot load plus journal replay
   (:meth:`DurableSketchIndex.recover`), replayed partition merges riding
   the bucketized merge kernel.  Corrupt snapshots fail their CRC and are
   quarantined, never loaded.  A loaded :class:`SketchIndex` has its row
   summaries recomputed from the restored values and taus and its
   summary epoch bumped (the reference leaves them at their fresh
   values); the bias-aware head state is not in the snapshot, as in the
   reference.
2. **Degraded-mode reads**: :class:`ResilientSketchIndex` /
   :class:`ResilientMatrixStore` split coordinates (rows) over
   independently seeded shards; with shards down, reads answer from the
   survivors and return a :class:`DegradedResult` with the coverage and
   the widened bound of :func:`repro_torch.core.surviving_corpus_bound`,
   or raise :class:`DegradedServiceError` in strict mode.
3. **Guarded fan-out**: each shard call runs through an injectable
   ``call_wrapper`` under a :class:`RetryPolicy` (exponential backoff, a
   per-call deadline, a ``TimeoutError`` terminal at once); a failed
   shard is marked down in :class:`ShardHealth` (explicit down-marks plus
   missed heartbeats, riding
   :class:`repro_torch.train.fault_tolerance.HeartbeatMonitor`) instead
   of failing the read.  The sharded discovery engine
   (:class:`repro_torch.serve.discovery.ShardedDiscoveryEngine`) guards
   its shard-pair tasks with the same policy and health.
4. **Input hardening**: every surface validates shapes and rejects or
   zeroes NaN/Inf (:mod:`repro_torch.serve.validation`).

The shards estimate on the port's kernels (the index's build, query,
all-pairs and merge kernels, the store's matrix-product kernel);
everything here around them is host numpy.
"""
from __future__ import annotations

import base64
import json
import os
import shutil
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import (coverage_fraction, fold_seed,
                              surviving_corpus_bound)
from repro_torch.device import resolve_device
from repro_torch.distributed import partition_bounds
from repro_torch.train.fault_tolerance import HeartbeatMonitor

from .sketch_service import MatrixSketchStore, SketchIndex
from .validation import check_finite, check_unique_name, check_vector

SNAPSHOT_FORMAT_VERSION = 1
_SNAP_PREFIX = "snapshot-"


class ResilienceError(RuntimeError):
    """Base class for serving-resilience failures."""


class SnapshotCorruptionError(ResilienceError):
    """A snapshot failed its integrity checks (CRC, shape, version,
    missing pieces): evidence of bad bytes, grounds for quarantine."""


class SnapshotReadError(ResilienceError):
    """A snapshot could not be read for environmental reasons
    (permissions, descriptor exhaustion, transient I/O): the bytes are not
    implicated, so the snapshot must not be quarantined."""


class ShardDownError(ResilienceError):
    """A shard call failed terminally (retries/deadline exhausted)."""


class DegradedServiceError(ResilienceError):
    """Strict-mode refusal: shards are down and degraded answers are not
    acceptable to this caller."""


def _host(x, dtype) -> np.ndarray:
    """A host array of ``dtype``: a tensor (on the card or not) is copied
    to the host once."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


# ---------------------------------------------------------------------------
# Durability: versioned checksummed snapshots
# ---------------------------------------------------------------------------


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _fsync_dir(path: str) -> None:
    """fsync a directory so its entries (new files, renames) are durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _snapshot_arrays(index) -> dict:
    """The occupied-prefix host arrays of an index, by kind."""
    D = len(index)
    if isinstance(index, SketchIndex):
        return {"idx": index._idx[:D], "val": index._val[:D],
                "tau": index._tau[:D], "dropped": index._dropped[:D]}
    if isinstance(index, MatrixSketchStore):
        return {"idx": index._idx[:D], "rows": index._rows[:D],
                "tau": index._tau[:D]}
    raise TypeError(f"cannot snapshot {type(index).__name__}")


def _snapshot_params(index) -> dict:
    """The manifest's ``params``: plain JSON ints and strings."""
    if isinstance(index, SketchIndex):
        return {"kind": "sketch_index", "m": int(index.m),
                "n_buckets": int(index.n_buckets), "slots": int(index.slots),
                "seed": int(index.seed), "nonfinite": index.nonfinite,
                "dim": None if index._dim is None else int(index._dim)}
    return {"kind": "matrix_store", "m": int(index.m), "dim": int(index.dim),
            "seed": int(index.seed), "nonfinite": index.nonfinite}


def save_snapshot(index, directory: str, *, journal_seq: int = 0) -> str:
    """Write one versioned snapshot of a :class:`SketchIndex` or
    :class:`MatrixSketchStore` under ``directory``; returns its path.

    Layout: ``snapshot-<journal_seq>/manifest.json`` plus one ``.npy`` a
    payload array (``idx``/``val``/``tau``/... over the occupied row
    prefix), each with its CRC32 in the manifest.  The write is atomic
    and durable: every payload and the manifest are fsync'd, then the tmp
    directory, then ``os.replace`` publishes it and the parent is
    fsync'd, so a crash mid-write never leaves a readable but wrong
    snapshot, and the journal rotation that follows a returned snapshot
    cannot orphan acknowledged ops.  A re-snapshot at the same
    ``journal_seq`` replaces the old one atomically.
    """
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"{_SNAP_PREFIX}{journal_seq:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = _snapshot_arrays(index)
    manifest = {
        "format_version": SNAPSHOT_FORMAT_VERSION,
        "journal_seq": int(journal_seq),
        "params": _snapshot_params(index),
        "names": list(index._names),
        "arrays": {},
    }
    for key, arr in arrays.items():
        fname = f"{key}.npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["arrays"][key] = {"file": fname, "crc32": _crc(arr),
                                   "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_dir(directory)
    return final


def _rebuild_index(params: dict, device=None, rows: int = 0):
    """An empty index or store with a manifest's ``params``, its blocks
    allocated for ``rows`` at once (the capacity the default's doublings
    would reach)."""
    if params["kind"] == "sketch_index":
        index = SketchIndex(params["m"], n_buckets=params["n_buckets"],
                            slots=params["slots"], seed=params["seed"],
                            nonfinite=params.get("nonfinite", "raise"),
                            initial_capacity=max(64, rows), device=device)
        index._dim = params.get("dim")
        return index
    return MatrixSketchStore(params["m"], dim=params["dim"],
                             seed=params["seed"],
                             nonfinite=params.get("nonfinite", "raise"),
                             initial_capacity=max(8, rows), device=device)


def _restore(index, names: list, arrays: dict) -> None:
    """Write the occupied prefix into fresh capacity-doubled blocks, then
    refresh what is derived from it: a :class:`SketchIndex`'s row
    summaries (a function of the values and taus) with its summary epoch
    bumped, and the lazy device copies dropped."""
    D = len(names)
    while index.capacity < max(D, 1):
        index._grow()
    for key, arr in arrays.items():
        getattr(index, f"_{key}")[:D] = arr
    index._names = list(names)
    index._name_set = set(names)
    if isinstance(index, SketchIndex):
        index._device_corpus = None
        index._refresh_row_stats(0, D)
    else:
        index._invalidate()


def load_snapshot(path: str, *, device=None):
    """Load one snapshot onto ``device`` (default ``cuda``), verifying its
    version and payload CRCs; returns ``(index, journal_seq)``.  Raises
    :class:`SnapshotCorruptionError` for bad bytes (CRC, shape or version
    mismatch, unparseable or missing pieces) and
    :class:`SnapshotReadError` for transient I/O failures that say nothing
    of the snapshot's integrity."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except FileNotFoundError as e:
        # the atomic publish never leaves a snapshot without its
        # manifest: absence is structural damage
        raise SnapshotCorruptionError(f"{path}: missing manifest "
                                      f"({e})") from e
    except json.JSONDecodeError as e:
        raise SnapshotCorruptionError(f"{path}: unreadable manifest "
                                      f"({e})") from e
    except OSError as e:
        raise SnapshotReadError(f"{path}: transient manifest read failure "
                                f"({e})") from e
    version = manifest.get("format_version")
    if version != SNAPSHOT_FORMAT_VERSION:
        raise SnapshotCorruptionError(
            f"{path}: snapshot format version {version!r} not supported "
            f"(this build reads version {SNAPSHOT_FORMAT_VERSION})")
    names = manifest["names"]
    index = _rebuild_index(manifest["params"], device, len(names))
    arrays = {}
    for key, meta in manifest["arrays"].items():
        fpath = os.path.join(path, meta["file"])
        try:
            arr = np.load(fpath)
        except (FileNotFoundError, ValueError) as e:
            raise SnapshotCorruptionError(f"{path}: unreadable payload "
                                          f"{meta['file']} ({e})") from e
        except OSError as e:
            raise SnapshotReadError(f"{path}: transient read failure on "
                                    f"payload {meta['file']} ({e})") from e
        if list(arr.shape) != meta["shape"] or str(arr.dtype) != meta["dtype"]:
            raise SnapshotCorruptionError(
                f"{path}: payload {key} is {arr.dtype}{arr.shape}, "
                f"manifest says {meta['dtype']}{tuple(meta['shape'])}")
        if _crc(arr) != meta["crc32"]:
            raise SnapshotCorruptionError(
                f"{path}: payload {key} failed its CRC32 integrity check "
                "(bit rot or tampering); refusing to load")
        if arr.shape[0] != len(names):
            raise SnapshotCorruptionError(
                f"{path}: payload {key} holds {arr.shape[0]} rows for "
                f"{len(names)} names")
        arrays[key] = arr
    _restore(index, names, arrays)
    return index, int(manifest["journal_seq"])


def list_snapshots(directory: str) -> list:
    """Snapshot paths under ``directory``, oldest first."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in sorted(os.listdir(directory)):
        if name.startswith(_SNAP_PREFIX) and not name.endswith(".tmp") \
                and "quarantined" not in name:
            out.append(os.path.join(directory, name))
    return out


def quarantine_snapshot(path: str, reason: str) -> str:
    """Move a corrupt snapshot aside (never delete evidence); returns the
    quarantine path."""
    dest = path + ".quarantined"
    k = 0
    while os.path.exists(dest):
        k += 1
        dest = f"{path}.quarantined.{k}"
    os.replace(path, dest)
    with open(os.path.join(dest, "QUARANTINE_REASON"), "w") as f:
        f.write(reason + "\n")
    obs.counter("repro_snapshot_quarantines_total",
                "corrupt snapshots moved aside by recovery").inc()
    return dest


def load_latest_snapshot(directory: str, *, device=None):
    """Load the newest snapshot that passes its integrity checks,
    quarantining the corrupt ones on the way down; returns ``(index,
    journal_seq)``, or ``(None, 0)`` when no snapshot is usable.  A
    transient read failure skips a snapshot without renaming it (the
    archived journal segments cover the gap)."""
    for path in reversed(list_snapshots(directory)):
        try:
            return load_snapshot(path, device=device)
        except SnapshotCorruptionError as e:
            quarantine_snapshot(path, str(e))
        except SnapshotReadError:
            continue
    return None, 0


# ---------------------------------------------------------------------------
# Durability: write-ahead ingest journal
# ---------------------------------------------------------------------------


def _enc(arr) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": base64.b64encode(arr.tobytes()).decode("ascii")}


_B64 = b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"
# payloads from this many characters up are decoded on a card: where the
# card overtakes binascii (scripts/recovery_breakdown.py's ``decode``)
_B64_ON_DEVICE = 1 << 18
_B64_LUT: dict = {}          # device -> (256,) int32 sextet table


def _b64_on(text: str, device) -> np.ndarray:
    """The bytes of padded base64 ``text`` (a multiple of 4 characters of
    the standard alphabet, as :func:`_enc` writes), decoded by tensor ops
    on ``device`` and copied back once."""
    lut = _B64_LUT.get(device)
    if lut is None:
        lut = torch.zeros(256, dtype=torch.int32)
        lut[torch.tensor(list(_B64))] = torch.arange(64, dtype=torch.int32)
        lut = _B64_LUT.setdefault(device, lut.to(device))
    raw = torch.from_numpy(np.frombuffer(bytearray(text, "ascii"), np.uint8))
    v = lut[raw.to(device).long()].view(-1, 4)
    w = (v[:, 0] << 18) | (v[:, 1] << 12) | (v[:, 2] << 6) | v[:, 3]
    out = torch.stack([w >> 16, (w >> 8) & 255, w & 255], 1).to(torch.uint8)
    pad = int((raw[-2:] == ord("=")).sum())
    return out.view(-1)[: out.numel() - pad].cpu().numpy()


def _dec(meta: dict, device=None) -> np.ndarray:
    """A payload array.  On a card a large payload's base64 is decoded
    there (bit-equal, several times binascii's speed); the result is
    always a writable host array."""
    text = meta["data"]
    if device is not None and torch.device(device).type == "cuda" and \
            len(text) >= _B64_ON_DEVICE and len(text) % 4 == 0:
        buf = _b64_on(text, torch.device(device))
    else:
        buf = bytearray(base64.b64decode(text))
    return np.frombuffer(buf, dtype=meta["dtype"]).reshape(meta["shape"])


_DATA_HEAD = b'{"data": "'
_BODY_HEAD = b'{"body": '
_BODY_TAIL = b', "crc": '


def _lines(data):
    """``(start, end)`` of each line of ``data``, split where
    ``bytes.splitlines`` splits (LF, CR, CRLF), the ends kept."""
    if b"\r" in data:
        pos = 0
        for line in data.splitlines(keepends=True):
            yield pos, pos + len(line)
            pos += len(line)
        return
    pos, n = 0, len(data)
    while pos < n:
        nl = data.find(b"\n", pos)
        end = n if nl < 0 else nl + 1
        yield pos, end
        pos = end


def _loads(data, lo: int, hi: int):
    """``json.loads`` of the journal line ``data[lo:hi]``, its base64
    payload strings cut out before the parse and put back after it
    (scanning them is most of a large record's parse).  Such a string
    starts right after an object opens with the key ``data`` (a quote
    inside a JSON string is escaped, so the pattern cannot start inside
    one) and holds no quote or backslash; any other layout is parsed
    whole."""
    pieces, blobs, pos = [], [], lo
    while (k := data.find(_DATA_HEAD, pos, hi)) >= 0:
        start = k + len(_DATA_HEAD)
        end = data.find(b'"', start, hi)
        if end < 0 or data.find(b"\\", start, end) >= 0:
            return json.loads(data[lo:hi])
        pieces.append(data[pos:start])
        blobs.append((start, end))
        pos = end
    if not blobs:
        return json.loads(data[lo:hi])
    pieces.append(data[pos:hi])
    rec = json.loads(b"".join(pieces))
    slots = []

    def walk(node):   # objects and arrays in text order
        if isinstance(node, dict):
            if node.get("data") == "":
                slots.append(node)
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    walk(rec)
    if len(slots) != len(blobs):
        return json.loads(data[lo:hi])
    view = memoryview(data)
    for node, (start, end) in zip(slots, blobs):
        node["data"] = str(view[start:end], "ascii")
    return rec


def _crc_ok(data, lo: int, hi: int, crc) -> bool:
    """Whether ``crc`` is the CRC32 of the line ``data[lo:hi]``'s body in
    its canonical encoding (``json.dumps(body, sort_keys=True)``).  A
    line that :meth:`IngestJournal._line` wrote holds that encoding
    verbatim between its leading ``{"body": `` and its ``, "crc": ``, so
    those bytes are checked in place; any other layout (or a mismatch
    there) is parsed whole and its body re-encoded."""
    end = data.rfind(_BODY_TAIL, lo, hi)
    if data.startswith(_BODY_HEAD, lo) and end > lo and zlib.crc32(
            memoryview(data)[lo + len(_BODY_HEAD):end]) & 0xFFFFFFFF == crc:
        return True
    canon = json.dumps(json.loads(data[lo:hi])["body"], sort_keys=True)
    return zlib.crc32(canon.encode()) & 0xFFFFFFFF == crc


class IngestJournal:
    """Append-only ingest journal (write-ahead log) with checkpoint
    rotation, in the reference's line format.

    One JSON record a line, ``{"seq", "op", "crc", "body"}`` with sorted
    keys, ``crc`` the CRC32 of the body's canonical encoding and array
    payloads in base64.  :meth:`read` replays records in order and stops
    at the first corrupt or truncated record: a crash mid-append loses at
    most the unacknowledged tail.  Opening the journal cuts such a tail
    at the byte offset of the last valid record before appending resumes,
    so a post-recovery append never lands after garbage.

    On each snapshot the live journal is :meth:`rotate`\\ d: archived as
    ``journal-<end_seq>.wal``, restarted with a ``checkpoint`` marker at
    the same sequence position.  Recovery (:meth:`read_all`) skips the
    archived segments that end at or before the snapshot's sequence, so
    it costs O(snapshot) + O(post-snapshot tail); the archives keep
    replay possible when a corrupt newest snapshot forces a fallback.
    """

    def __init__(self, path: str, *, seq: Optional[int] = None,
                 valid_end: Optional[int] = None):
        """``seq``: resume numbering from a known position (recovery
        already parsed it).  ``valid_end``: byte offset past the last
        valid record from a scan the caller already ran
        (:meth:`scan_all`): skips the re-scan but still cuts the corrupt
        tail.  Without it the file is scanned here; either way the tail
        is cut before the file reopens for append."""
        self.path = path
        self._seq = seq if seq is not None else 0
        if os.path.exists(path):
            if seq is not None and valid_end is not None:
                if os.path.getsize(path) > valid_end:
                    os.truncate(path, valid_end)
            else:
                records, dropped, v_end = self._scan(path)
                if dropped:
                    os.truncate(path, v_end)
                if seq is None and records:
                    self._seq = records[-1][0]
        self._fh = open(path, "a")

    @property
    def seq(self) -> int:
        """Sequence number of the last acknowledged record."""
        return self._seq

    @staticmethod
    def _line(seq: int, op: str, body: dict) -> str:
        """``json.dumps({"seq", "op", "crc", "body"}, sort_keys=True)``
        and a newline, the body encoded once: with sorted keys the record
        is its canonical body encoding between ``{"body": `` and the
        other three fields."""
        canon = json.dumps(body, sort_keys=True)
        crc = zlib.crc32(canon.encode()) & 0xFFFFFFFF
        return (f'{{"body": {canon}, "crc": {crc}, "op": {json.dumps(op)}, '
                f'"seq": {json.dumps(seq)}}}\n')

    def append(self, op: str, body: dict) -> int:
        """Durably append one op (fsync'd before it is acknowledged);
        returns its sequence number."""
        self._seq += 1
        self._fh.write(self._line(self._seq, op, body))
        self._fh.flush()
        os.fsync(self._fh.fileno())
        obs.counter("repro_wal_appends_total",
                    "acknowledged journal records", ("op",)).labels(op).inc()
        return self._seq

    def rotate(self) -> str:
        """Checkpoint the journal after a snapshot at the current seq:
        archive the live file as ``journal-<seq>.wal`` and restart it
        with a ``checkpoint`` marker.  Each step is atomic; a crash
        between them costs recovery speed, never acknowledged records."""
        self._fh.close()
        archive = os.path.join(os.path.dirname(self.path) or ".",
                               f"journal-{self._seq:010d}.wal")
        os.replace(self.path, archive)
        with open(self.path, "w") as f:
            f.write(self._line(self._seq, "checkpoint",
                               {"snapshot_seq": self._seq}))
            f.flush()
            os.fsync(f.fileno())
        self._fh = open(self.path, "a")
        obs.counter("repro_wal_rotations_total",
                    "journal checkpoint rotations").inc()
        return archive

    def close(self) -> None:
        self._fh.close()

    @staticmethod
    def _scan(path: str, after_seq: int = 0):
        """Parse the journal with byte offsets: ``(records, tail_dropped,
        valid_end)``, ``valid_end`` just past the last valid
        newline-terminated record.  A final record without its newline is
        tail (an acknowledged record was fsync'd whole).  Records at or
        before ``after_seq`` are walked but not checksummed: their bytes
        are already in the snapshot being recovered from."""
        records = []
        dropped = 0
        valid_end = 0
        try:
            with open(path, "rb") as f:
                data = bytearray(os.fstat(f.fileno()).st_size)
                del data[f.readinto(data):]
        except OSError:
            return records, dropped, valid_end
        lines = list(_lines(data))
        for i, (lo, hi) in enumerate(lines):
            try:
                if data[hi - 1:hi] != b"\n":
                    raise ValueError("truncated record (no terminator)")
                rec = _loads(data, lo, hi)
                seq, op, body = int(rec["seq"]), rec["op"], rec["body"]
                if seq > after_seq and not _crc_ok(data, lo, hi, rec["crc"]):
                    raise ValueError("CRC mismatch")
            except (ValueError, KeyError, TypeError, UnicodeDecodeError):
                dropped = len(lines) - i
                break
            valid_end += hi - lo
            if seq > after_seq:
                records.append((seq, op, body))
        return records, dropped, valid_end

    @classmethod
    def read(cls, path: str, *, after_seq: int = 0):
        """``(records, tail_dropped)``: records ``(seq, op, body)`` with
        ``seq > after_seq``, up to the first that fails to parse or
        verify."""
        records, dropped, _ = cls._scan(path, after_seq)
        return records, dropped

    @classmethod
    def scan_all(cls, path: str, *, after_seq: int = 0):
        """:meth:`read_all` plus the live journal's ``valid_end`` (``None``
        when a corrupt archive stopped the scan before the live file)."""
        directory = os.path.dirname(path) or "."
        segments = []
        if os.path.isdir(directory):
            for name in sorted(os.listdir(directory)):
                if name.startswith("journal-") and name.endswith(".wal"):
                    try:
                        end_seq = int(name[len("journal-"):-len(".wal")])
                    except ValueError:
                        continue
                    if end_seq > after_seq:
                        segments.append(os.path.join(directory, name))
        records = []
        for seg in segments + [path]:
            recs, dropped, valid_end = cls._scan(seg, after_seq)
            records.extend(recs)
            live_end = valid_end if seg == path else None
            if dropped:
                return records, dropped, live_end
        return records, 0, live_end

    @classmethod
    def read_all(cls, path: str, *, after_seq: int = 0):
        """Archived segments plus the live journal, skipping whole
        segments that end at or before ``after_seq``; stops at the first
        corrupt record."""
        records, dropped, _ = cls.scan_all(path, after_seq=after_seq)
        return records, dropped


class DurableSketchIndex:
    """A :class:`SketchIndex` with crash durability: every ingest op is
    journaled on acknowledgement, snapshots are cut every
    ``snapshot_every`` ops, and :meth:`recover` rebuilds the pre-crash
    index as snapshot load plus journal replay.

    Replay re-runs the same deterministic builds, so recovery is
    bit-exact; a replayed ``merge_from`` rides the bucketized merge
    kernel as the original call did.  Journal bodies hold host bytes: a
    tensor input is copied to the host once.  ``index_kwargs`` (``device``
    included) make the index when none is given.
    """

    def __init__(self, directory: str, *, snapshot_every: Optional[int] = None,
                 index: Optional[SketchIndex] = None,
                 _journal_seq: Optional[int] = None,
                 _journal_valid_end: Optional[int] = None, **index_kwargs):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.index = index if index is not None else SketchIndex(**index_kwargs)
        self.snapshot_every = snapshot_every
        self._ops_since_snapshot = 0
        self.journal = IngestJournal(os.path.join(directory, "journal.wal"),
                                     seq=_journal_seq,
                                     valid_end=_journal_valid_end)

    # -- ingest (journaled) --------------------------------------------
    def add(self, name, vector=None, *, indices=None, values=None) -> None:
        if vector is not None:
            vector = _host(vector, np.float32)
        if indices is not None:
            indices = _host(indices, np.int32)
        if values is not None:
            values = _host(values, np.float32)
        self.index.add(name, vector, indices=indices, values=values)
        body = {"name": name}
        if vector is not None:
            body["vector"] = _enc(vector)
        else:
            body["indices"] = _enc(indices)
            body["values"] = _enc(values)
        self.journal.append("add", body)
        self._maybe_snapshot()

    def add_many(self, names: Sequence, matrix) -> None:
        matrix = _host(matrix, np.float32)
        self.index.add_many(names, matrix)
        self.journal.append("add_many", {"names": list(names),
                                         "matrix": _enc(matrix)})
        self._maybe_snapshot()

    def merge_from(self, other: SketchIndex) -> None:
        """Journaled partition-peer merge: the peer's occupied blocks ride
        the journal, so replay re-applies the merge verbatim."""
        self.index.merge_from(other)
        D = len(other)
        self.journal.append("merge_from", {
            "params": _snapshot_params(other), "names": list(other._names),
            "idx": _enc(other._idx[:D]), "val": _enc(other._val[:D]),
            "tau": _enc(other._tau[:D]), "dropped": _enc(other._dropped[:D])})
        self._maybe_snapshot()

    # -- reads (delegated) ---------------------------------------------
    def query(self, vector, top_k=None):
        return self.index.query(vector, top_k)

    def all_pairs(self, **kw):
        return self.index.all_pairs(**kw)

    def __len__(self):
        return len(self.index)

    # -- snapshots ------------------------------------------------------
    def snapshot(self) -> str:
        """Cut a snapshot at the current journal position, then
        checkpoint the journal, so recovery replays only later ops."""
        with obs.op("serve.durable.snapshot") as sp:
            sp.set("journal_seq", self.journal.seq)
            path = save_snapshot(self.index, self._snap_dir(),
                                 journal_seq=self.journal.seq)
            self.journal.rotate()
            self._ops_since_snapshot = 0
            obs.counter("repro_snapshots_total",
                        "snapshots cut (with journal checkpoint)").inc()
            return path

    def _snap_dir(self) -> str:
        return os.path.join(self.directory, "snapshots")

    def _maybe_snapshot(self) -> None:
        self._ops_since_snapshot += 1
        if self.snapshot_every and \
                self._ops_since_snapshot >= self.snapshot_every:
            self.snapshot()

    # -- recovery -------------------------------------------------------
    @staticmethod
    def _apply(index: SketchIndex, op: str, body: dict, device) -> None:
        if op == "add":
            if "vector" in body:
                index.add(body["name"], _dec(body["vector"], device))
            else:
                index.add(body["name"], indices=_dec(body["indices"], device),
                          values=_dec(body["values"], device))
        elif op == "add_many":
            index.add_many(body["names"], _dec(body["matrix"], device))
        elif op == "merge_from":
            peer = _rebuild_index(body["params"], index.device,
                                  len(body["names"]))
            _restore(peer, body["names"],
                     {k: _dec(body[k], device)
                      for k in ("idx", "val", "tau", "dropped")})
            index.merge_from(peer)
        else:
            raise ResilienceError(f"journal contains unknown op {op!r}")

    @classmethod
    def recover(cls, directory: str, *,
                snapshot_every: Optional[int] = None, **index_kwargs):
        """Rebuild the pre-crash index: the newest intact snapshot (corrupt
        ones quarantined) plus a replay of the journal tail, bit-exact
        against the crashed instance's acknowledged state.
        ``index_kwargs`` make the index when no snapshot is usable; their
        ``device`` is where a snapshot loads."""
        with obs.op("serve.durable.recover") as sp:
            device = resolve_device(index_kwargs.get("device"))
            index, seq = load_latest_snapshot(
                os.path.join(directory, "snapshots"), device=device)
            if index is None:
                index = SketchIndex(**index_kwargs)
            records, dropped, live_end = IngestJournal.scan_all(
                os.path.join(directory, "journal.wal"), after_seq=seq)
            last_seq = records[-1][0] if records else seq
            records = [r for r in records if r[1] != "checkpoint"]
            for _, op, body in records:
                cls._apply(index, op, body, device)
            out = cls(directory, snapshot_every=snapshot_every, index=index,
                      _journal_seq=last_seq, _journal_valid_end=live_end)
            out.replayed_ops = len(records)
            out.dropped_tail = dropped
            sp.set("replayed_ops", out.replayed_ops)
            sp.set("dropped_tail", out.dropped_tail)
            if obs.enabled():
                snap_path = os.path.join(directory, "snapshots",
                                         f"{_SNAP_PREFIX}{seq:010d}")
                mtime = os.path.getmtime(snap_path) \
                    if seq and os.path.isdir(snap_path) else None
                from repro_torch.obs.quality import observe_recovery
                observe_recovery(obs.registry(),
                                 replayed_ops=out.replayed_ops,
                                 dropped_tail=out.dropped_tail,
                                 snapshot_mtime=mtime)
            return out


# ---------------------------------------------------------------------------
# Guarded fan-out: health tracking + retry/backoff/deadline
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Retry with exponential backoff and a per-call deadline.

    ``attempts`` total tries; backoff sleeps ``base_delay * 2^k`` capped at
    ``max_delay``; once ``deadline`` seconds have elapsed for this call no
    further retries are attempted.  A ``TimeoutError`` from the shard call
    is terminal immediately: a hanging shard should be marked unhealthy,
    not retried into.
    """
    attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    deadline: Optional[float] = 5.0


@dataclass
class ShardHealth:
    """Shard liveness = explicit down-marks + missed heartbeats.

    Shards that stop beating for ``timeout`` seconds are treated as down
    even if no call has failed yet; a successful call or a fresh heartbeat
    revives a down-marked shard.  Pass ``monitor`` to share one with the
    cluster manager: its ``timeout`` then wins, and beats it already
    recorded are preserved (only shards it has never seen are registered
    live at construction time).
    """
    num_shards: int
    timeout: float = 60.0
    clock: Callable[[], float] = time.monotonic
    monitor: Optional[HeartbeatMonitor] = None
    down_reasons: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.monitor is None:
            self.monitor = HeartbeatMonitor(timeout=self.timeout)
        else:
            self.timeout = self.monitor.timeout
        now = self.clock()
        for p in range(self.num_shards):
            if p not in self.monitor.last_seen:
                self.monitor.beat(p, now=now)

    def beat(self, shard: int) -> None:
        """A heartbeat (or successful call) proves liveness and revives."""
        self.down_reasons.pop(shard, None)
        self.monitor.beat(shard, now=self.clock())

    def mark_down(self, shard: int, reason: str = "marked down") -> None:
        self.down_reasons[shard] = reason

    def down_shards(self) -> dict:
        """shard -> reason for every shard currently considered down."""
        out = dict(self.down_reasons)
        for shard in self.monitor.dead_workers(self.clock()):
            out.setdefault(shard, f"no heartbeat for > {self.timeout}s")
        return out

    def is_up(self, shard: int) -> bool:
        return shard not in self.down_shards()


@dataclass(frozen=True)
class DegradedResult:
    """A degraded-mode read: the unbiased surviving-corpus estimate with
    an account of what is missing.

    ``coverage`` is the share of the relevant squared-norm mass the
    surviving shards served (1.0 when healthy); ``bound`` is the widened
    error bound against the FULL answer (the sampling Chebyshev
    half-width over the survivors plus the Cauchy-Schwarz bound on the
    lost mass), holding with probability ``1 - delta`` an estimate.
    """
    names: tuple
    estimates: np.ndarray
    coverage: float
    bound: np.ndarray
    sampling_bound: np.ndarray
    lost_mass_bound: np.ndarray
    down_shards: tuple
    delta: float

    @property
    def degraded(self) -> bool:
        return len(self.down_shards) > 0

    def top_k(self, k: int) -> list:
        """(name, estimate, bound) for the k largest estimates of a 1-D
        (query) result."""
        est = np.asarray(self.estimates)
        order = np.argsort(-est)[:k]
        return [(self.names[i], float(est[i]), float(self.bound[i]))
                for i in order]


def _publish_degraded(coverage: float, lost_any: bool, surface: str) -> None:
    """The coverage gauge of a surface, and a count of the answers served
    degraded."""
    if not obs.enabled():
        return
    obs.quality_monitor().observe_coverage(coverage, surface)
    if lost_any:
        obs.counter("repro_degraded_results_total",
                    "fan-out answers served with coverage < 1",
                    ("surface",)).labels(surface).inc()


class _GuardedFanout:
    """The shard-call guard: injectable wrapper, retry with backoff, a
    deadline, health bookkeeping.  Shards are called one after another."""

    def __init__(self, num_shards: int, *, strict: bool, delta: float,
                 retry: Optional[RetryPolicy], call_wrapper, sleep,
                 heartbeat_timeout: float, clock=time.monotonic):
        self.strict = strict
        self.delta = delta
        self.retry = retry if retry is not None else RetryPolicy()
        self.health = ShardHealth(num_shards, timeout=heartbeat_timeout,
                                  clock=clock)
        self._call_wrapper = call_wrapper
        self._sleep = sleep
        self._clock = clock

    def heartbeat(self, shard: int) -> None:
        """Feed one shard heartbeat (cluster-manager integration point)."""
        self.health.beat(shard)

    def kill_shard(self, shard: int, reason: str = "killed") -> None:
        """Administratively mark a shard down (tests, drains, chaos)."""
        self.health.mark_down(shard, reason)

    def revive_shard(self, shard: int) -> None:
        self.health.beat(shard)

    def down_shards(self) -> dict:
        return self.health.down_shards()

    def _shard_call(self, shard: int, fn: Callable):
        """One guarded call; raises :class:`ShardDownError` (after marking
        the shard down) when retries or the deadline are exhausted."""
        policy = self.retry
        t0 = self._clock()
        delay = policy.base_delay
        last: Optional[BaseException] = None
        with obs.span("serve.shard_call") as tsp:
            tsp.set("shard", shard)
            for attempt in range(max(policy.attempts, 1)):
                try:
                    obs.counter("repro_retry_attempts_total",
                                "guarded-call attempts",
                                ("surface",)).labels("serve").inc()
                    if self._call_wrapper is not None:
                        out = self._call_wrapper(shard, fn)
                    else:
                        out = fn()
                    self.health.beat(shard)   # success proves liveness
                    return out
                except Exception as e:  # noqa: BLE001 — the fault boundary
                    last = e
                    timed_out = isinstance(e, TimeoutError) or (
                        policy.deadline is not None
                        and self._clock() - t0 >= policy.deadline)
                    if timed_out:
                        obs.counter("repro_deadline_hits_total",
                                    "guarded calls terminated by timeout "
                                    "or deadline",
                                    ("surface",)).labels("serve").inc()
                    if timed_out or attempt >= policy.attempts - 1:
                        break
                    obs.counter("repro_retry_backoffs_total",
                                "backoff sleeps between retries",
                                ("surface",)).labels("serve").inc()
                    self._sleep(delay)
                    delay = min(delay * 2.0, policy.max_delay)
            self.health.mark_down(shard, f"{type(last).__name__}: {last}")
            obs.counter("repro_shard_down_total",
                        "guarded tasks that exhausted their retries",
                        ("surface",)).labels("serve").inc()
            raise ShardDownError(f"shard {shard} failed after "
                                 f"{attempt + 1} attempt(s): {last}") from last

    def _fan_out(self, shards: Sequence[int], fn_of: Callable):
        """Call ``fn_of(shard)`` on every shard that is up; returns
        ``(results: shard -> value, down: shard -> reason)``."""
        results = {}
        for p in shards:
            if not self.health.is_up(p):
                continue
            try:
                results[p] = self._shard_call(p, fn_of(p))
            except ShardDownError:
                continue
        down = self.health.down_shards()
        obs.gauge("repro_shards_down", "shards currently marked down",
                  ("surface",)).labels("serve").set(len(down))
        return results, down

    def _check_strict(self, strict: Optional[bool], down: dict,
                      n_served: int) -> None:
        strict = self.strict if strict is None else strict
        if down and strict:
            raise DegradedServiceError(
                f"shards down: { {p: r for p, r in sorted(down.items())} } "
                "— refusing a degraded answer in strict mode")
        if n_served == 0:
            raise ShardDownError(
                f"no surviving shards (down: {sorted(down)}); nothing to "
                "answer from")

    def _split(self, results: dict) -> tuple:
        """(surviving, lost) shard ids, ascending."""
        surv = np.array(sorted(results), np.int64)
        lost = np.array(sorted(set(range(self.num_shards)) - set(results)),
                        np.int64)
        return surv, lost


# ---------------------------------------------------------------------------
# Degraded-mode serving indexes
# ---------------------------------------------------------------------------


def _all_or_none(shards, writes, *, rows_each: int) -> None:
    """Run the per-shard ``writes`` (thunks aligned with ``shards``),
    rolling back the shards already written if a later one fails (a
    ``MemoryError`` growing its blocks, say); without the unwind the
    shards would disagree on their corpus sizes and every later read
    would fail."""
    done = 0
    try:
        for write in writes:
            write()
            done += 1
    except BaseException:
        for shard in shards[:done]:
            shard._rollback_last(rows_each)
        raise


def _bounds(*args, m: int, delta: float) -> tuple:
    """:func:`surviving_corpus_bound` as host arrays."""
    return tuple(t.numpy() for t in surviving_corpus_bound(
        *args, m, delta, method="priority"))


class ResilientSketchIndex(_GuardedFanout):
    """Coordinate-partitioned fault-tolerant serving index.

    The coordinates ``[0, n)`` split into ``num_shards`` contiguous slices
    (:func:`repro_torch.distributed.partition_bounds`); each shard is a
    :class:`SketchIndex` over its slice with its own folded seed
    (``fold_seed(seed, 0x5EED + p)``, as the reference's), so the shards'
    estimates are independent and degraded variances add.  Every vector
    lives on every shard (its slice of coordinates on each), and a read
    sums the shards' sub-inner-product estimates:

    - healthy: the sum is the usual unbiased estimate;
    - shards down: the survivors' sum is unbiased for the surviving
      sub-inner-product, returned as a :class:`DegradedResult` with the
      coverage and the widened bound, or refused with
      :class:`DegradedServiceError` when ``strict``.

    Ingest needs every shard (a partial write would bias later reads), so
    ``add`` / ``add_many`` raise if any shard rejects, after rolling the
    others back.  ``device`` goes to every shard.
    """

    def __init__(self, n: int, num_shards: int = 4, *, m: int = 256,
                 n_buckets: int = 512, slots: int = 4, seed: int = 11,
                 initial_capacity: int = 64, nonfinite: str = "raise",
                 strict: bool = False, delta: float = 0.05,
                 retry: Optional[RetryPolicy] = None,
                 call_wrapper: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 heartbeat_timeout: float = 60.0, clock=time.monotonic,
                 device=None):
        self.n = n
        self.bounds = partition_bounds(n, num_shards)
        self.num_shards = len(self.bounds)
        super().__init__(self.num_shards, strict=strict, delta=delta,
                         retry=retry, call_wrapper=call_wrapper, sleep=sleep,
                         heartbeat_timeout=heartbeat_timeout, clock=clock)
        self.seed = seed
        self.m = m
        self.nonfinite = nonfinite
        self._shards = [
            SketchIndex(m, n_buckets=n_buckets, slots=slots,
                        seed=int(fold_seed(seed, 0x5EED + p)),
                        initial_capacity=initial_capacity,
                        nonfinite=nonfinite, device=device)
            for p in range(self.num_shards)]
        self._names: list = []
        self._norm2: list = []   # a row's (num_shards,) slice squared norms

    def __len__(self):
        return len(self._names)

    @property
    def names(self) -> tuple:
        return tuple(self._names)

    def _slices(self, arr: np.ndarray) -> list:
        return [arr[..., lo:hi] for lo, hi in self.bounds]

    # -- ingestion (requires all shards) --------------------------------
    def add(self, name, vector) -> None:
        check_unique_name(name, self._names)
        vector = check_vector(vector, f"vector {name!r}", dim=self.n,
                              nonfinite=self.nonfinite)
        slices = self._slices(vector)
        _all_or_none(self._shards,
                     [lambda p=p, sl=sl: self._shards[p].add(name, sl)
                      for p, sl in enumerate(slices)], rows_each=1)
        self._names.append(name)
        self._norm2.append(np.array([float(np.sum(sl * sl.astype(np.float64)))
                                     for sl in slices]))

    def add_many(self, names: Sequence, matrix) -> None:
        matrix = np.asarray(matrix, np.float32)
        if matrix.ndim != 2 or matrix.shape[0] != len(names):
            raise ValueError("matrix must be (len(names), n)")
        if matrix.shape[1] != self.n:
            raise ValueError(f"matrix has {matrix.shape[1]} coordinates but "
                             f"this index was built over {self.n}")
        for name in names:
            check_unique_name(name, self._names)
        matrix = check_finite(matrix, "ingest matrix",
                              nonfinite=self.nonfinite)
        _all_or_none(self._shards,
                     [lambda p=p, sl=sl: self._shards[p].add_many(names, sl)
                      for p, sl in enumerate(self._slices(matrix))],
                     rows_each=len(names))
        sq = matrix.astype(np.float64) ** 2
        per_shard = np.stack([sl.sum(axis=1) for sl in self._slices(sq)],
                             axis=1)
        self._names.extend(names)
        self._norm2.extend(list(per_shard))

    # -- degraded-mode reads --------------------------------------------
    def query(self, vector, *, delta: Optional[float] = None,
              strict: Optional[bool] = None) -> DegradedResult:
        """Estimates of ``vector`` against every indexed vector from the
        surviving shards (one query-kernel launch a shard).

        ``estimates[d]`` is unbiased for the surviving-coordinate
        sub-inner-product, ``coverage`` is the share of ``||q||^2`` on
        the surviving shards, and ``bound[d]`` bounds ``|estimates[d] -
        <q, v_d>|`` (the FULL answer) with probability ``1 - delta``.
        """
        if not self._names:
            raise ValueError("query on an empty index: add vectors before "
                             "querying")
        delta = self.delta if delta is None else delta
        vector = check_vector(vector, "query vector", dim=self.n,
                              nonfinite=self.nonfinite)
        slices = self._slices(vector)
        results, down = self._fan_out(
            range(self.num_shards),
            lambda p: (lambda: self._shards[p].query(slices[p])))
        self._check_strict(strict, down, len(results))
        D = len(self._names)
        est = np.zeros(D, np.float64)
        for per in results.values():
            est += np.array([e for _, e in per])
        q2 = np.array([float(np.sum(sl.astype(np.float64) ** 2))
                       for sl in slices])
        V2 = np.asarray(self._norm2)                    # (D, P)
        surv, lost = self._split(results)
        sampling, lost_mass, widened = _bounds(
            q2[surv], V2[:, surv], q2[lost], V2[:, lost], m=self.m,
            delta=delta)
        cov = float(coverage_fraction(q2[surv], q2[lost]))
        _publish_degraded(cov, bool(lost.size), "serve.query")
        return DegradedResult(
            names=tuple(self._names), estimates=est.astype(np.float32),
            coverage=cov, bound=widened, sampling_bound=sampling,
            lost_mass_bound=lost_mass,
            down_shards=tuple(sorted(down)), delta=delta)

    def all_pairs(self, *, delta: Optional[float] = None,
                  strict: Optional[bool] = None) -> DegradedResult:
        """(D, D) estimates summed over the surviving shards (one
        all-pairs launch a shard), with a (D, D) widened bound and the
        corpus-mass coverage."""
        if not self._names:
            raise ValueError("all_pairs on an empty index")
        delta = self.delta if delta is None else delta
        results, down = self._fan_out(
            range(self.num_shards),
            lambda p: (lambda: self._shards[p].all_pairs()))
        self._check_strict(strict, down, len(results))
        D = len(self._names)
        est = np.zeros((D, D), np.float64)
        for blk in results.values():
            est += blk
        V2 = np.asarray(self._norm2)                    # (D, P)
        surv, lost = self._split(results)
        lead = 2.0 / max(self.m - 1, 1)
        Vs = V2[:, surv]
        sampling = np.sqrt(lead / delta * (Vs @ Vs.T))
        lost_root = np.sqrt(V2[:, lost].sum(axis=1))
        lost_mass = np.outer(lost_root, lost_root)
        cov = float(coverage_fraction(Vs.sum(axis=0), V2[:, lost].sum(axis=0)))
        _publish_degraded(cov, bool(lost.size), "serve.all_pairs")
        return DegradedResult(
            names=tuple(self._names), estimates=est.astype(np.float32),
            coverage=cov, bound=sampling + lost_mass,
            sampling_bound=sampling, lost_mass_bound=lost_mass,
            down_shards=tuple(sorted(down)), delta=delta)


class ResilientMatrixStore(_GuardedFanout):
    """Row-partitioned fault-tolerant :class:`MatrixSketchStore`.

    ``A^T B = sum_p A_p^T B_p`` over row partitions, so each shard holds a
    :class:`MatrixSketchStore` over its row slice (its own folded seed)
    and degraded products sum the survivors: unbiased for the surviving
    row mass, with Frobenius sampling and lost-mass bounds as the vector
    path's.  ``device`` goes to every shard.
    """

    def __init__(self, n_rows: int, dim: int, num_shards: int = 4, *,
                 m: int = 128, seed: int = 11, nonfinite: str = "raise",
                 strict: bool = False, delta: float = 0.05,
                 retry: Optional[RetryPolicy] = None,
                 call_wrapper: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 heartbeat_timeout: float = 60.0, clock=time.monotonic,
                 device=None):
        self.n_rows = n_rows
        self.dim = dim
        self.bounds = partition_bounds(n_rows, num_shards)
        self.num_shards = len(self.bounds)
        super().__init__(self.num_shards, strict=strict, delta=delta,
                         retry=retry, call_wrapper=call_wrapper, sleep=sleep,
                         heartbeat_timeout=heartbeat_timeout, clock=clock)
        self.m = m
        self.nonfinite = nonfinite
        self._shards = [
            MatrixSketchStore(m, dim=dim,
                              seed=int(fold_seed(seed, 0x5EED + p)),
                              nonfinite=nonfinite, device=device)
            for p in range(self.num_shards)]
        self._names: list = []
        self._fro2: dict = {}    # name -> (num_shards,) slice Frobenius^2

    def __len__(self):
        return len(self._names)

    def add(self, name, matrix) -> None:
        check_unique_name(name, self._names, what="store")
        matrix = np.asarray(matrix, np.float32)
        if matrix.shape != (self.n_rows, self.dim):
            raise ValueError(f"expected a ({self.n_rows}, {self.dim}) "
                             f"matrix, got shape {matrix.shape}")
        matrix = check_finite(matrix, f"matrix {name!r}",
                              nonfinite=self.nonfinite)
        _all_or_none(self._shards,
                     [lambda p=p, lo=lo, hi=hi:
                      self._shards[p].add(name, matrix[lo:hi])
                      for p, (lo, hi) in enumerate(self.bounds)],
                     rows_each=1)
        self._names.append(name)
        self._fro2[name] = np.array(
            [float(np.sum(matrix[lo:hi].astype(np.float64) ** 2))
             for lo, hi in self.bounds])

    def _pair_bounds(self, fa2, fb2, surv, lost, delta):
        sampling, lost_mass, widened = _bounds(
            fa2[..., surv], fb2[..., surv], fa2[..., lost], fb2[..., lost],
            m=self.m, delta=delta)
        cov = float(coverage_fraction(
            (fa2[..., surv] + fb2[..., surv]).reshape(-1),
            (fa2[..., lost] + fb2[..., lost]).reshape(-1)))
        return sampling, lost_mass, widened, cov

    def product(self, name_a, name_b, *, delta: Optional[float] = None,
                strict: Optional[bool] = None) -> DegradedResult:
        """(d, d) estimate of ``A^T B`` summed over the surviving row
        shards, with a scalar widened Frobenius-error bound."""
        return self._products([(name_a, name_b)], delta=delta,
                              strict=strict, squeeze=True)

    def products(self, pairs: Sequence, *, delta: Optional[float] = None,
                 strict: Optional[bool] = None) -> DegradedResult:
        """(len(pairs), d, d) batched estimates from the surviving shards
        (one matrix-product launch a shard on the card)."""
        return self._products(list(pairs), delta=delta, strict=strict,
                              squeeze=False)

    def _products(self, pairs, *, delta, strict, squeeze):
        delta = self.delta if delta is None else delta
        for a, b in pairs:
            for name in (a, b):
                if name not in self._fro2:
                    raise KeyError(f"unknown matrix {name!r}")
        results, down = self._fan_out(
            range(self.num_shards),
            lambda p: (lambda: np.asarray(self._shards[p].products(pairs))))
        self._check_strict(strict, down, len(results))
        est = np.zeros((len(pairs), self.dim, self.dim), np.float64)
        for blk in results.values():
            est += blk
        surv, lost = self._split(results)
        fa2 = np.stack([self._fro2[a] for a, _ in pairs])   # (N, P)
        fb2 = np.stack([self._fro2[b] for _, b in pairs])
        sampling, lost_mass, widened, cov = self._pair_bounds(
            fa2, fb2, surv, lost, delta)
        if squeeze:
            est, sampling = est[0], sampling[..., 0]
            lost_mass, widened = lost_mass[..., 0], widened[..., 0]
        return DegradedResult(
            names=tuple(pairs), estimates=est.astype(np.float32),
            coverage=cov, bound=np.asarray(widened),
            sampling_bound=np.asarray(sampling),
            lost_mass_bound=np.asarray(lost_mass),
            down_shards=tuple(sorted(down)), delta=delta)

    def query(self, matrix, *, delta: Optional[float] = None,
              strict: Optional[bool] = None) -> DegradedResult:
        """Estimate ``Q^T A_c`` against every stored matrix from the
        surviving shards; ``estimates`` is (C, d, d) in insertion order."""
        if not self._names:
            raise ValueError("query on an empty store: add matrices before "
                             "querying")
        delta = self.delta if delta is None else delta
        matrix = np.asarray(matrix, np.float32)
        if matrix.shape != (self.n_rows, self.dim):
            raise ValueError(f"expected a ({self.n_rows}, {self.dim}) "
                             f"query matrix, got shape {matrix.shape}")
        matrix = check_finite(matrix, "query matrix",
                              nonfinite=self.nonfinite)
        results, down = self._fan_out(
            range(self.num_shards),
            lambda p: (lambda lo=self.bounds[p][0], hi=self.bounds[p][1]:
                       [est for _, est in
                        self._shards[p].query(matrix[lo:hi])]))
        self._check_strict(strict, down, len(results))
        C = len(self._names)
        est = np.zeros((C, self.dim, self.dim), np.float64)
        for per in results.values():
            est += np.stack([np.asarray(e) for e in per])
        surv, lost = self._split(results)
        q2 = np.array([float(np.sum(matrix[lo:hi].astype(np.float64) ** 2))
                       for lo, hi in self.bounds])
        F2 = np.stack([self._fro2[name] for name in self._names])  # (C, P)
        sampling, lost_mass, widened = _bounds(
            q2[surv], F2[:, surv], q2[lost], F2[:, lost], m=self.m,
            delta=delta)
        cov = float(coverage_fraction(q2[surv], q2[lost]))
        _publish_degraded(cov, bool(lost.size), "serve.matrix_query")
        return DegradedResult(
            names=tuple(self._names), estimates=est.astype(np.float32),
            coverage=cov, bound=widened, sampling_bound=sampling,
            lost_mass_bound=lost_mass,
            down_shards=tuple(sorted(down)), delta=delta)
