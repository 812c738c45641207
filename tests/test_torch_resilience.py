"""The port's resilience layer (``repro_torch.serve.resilience``) on the
CPU: the reference's chaos suite (``tests/test_resilience.py``) run
against the port, and the port held against the live reference on the
same numpy-made inputs: snapshots and journals written by either package
recover in the other bit for bit, both packages' recoveries of the same op
sequence agree bit for bit (with a torn journal tail and with a corrupt
snapshot), and the degraded reads of both agree under the same kills.
The two departures from the reference are pinned: a recovered port index
has its row summaries recomputed (the reference's are zeros), and the
bias-aware head state is not in a snapshot in either package."""
import json
import os

import numpy as np
import pytest
import torch

from _torch_common import assert_bits, assert_close
from _torch_common import release_jax_executables  # noqa: F401

import repro.serve as J
import repro_torch.serve as T
from repro_torch.serve import (DegradedServiceError, DurableSketchIndex,
                               IngestJournal, MatrixSketchStore,
                               ResilientMatrixStore, ResilientSketchIndex,
                               RetryPolicy, ShardDownError, ShardHealth,
                               SketchIndex, SnapshotCorruptionError,
                               SnapshotReadError, list_snapshots,
                               load_latest_snapshot, load_snapshot,
                               save_snapshot)
from repro_torch.train.fault_tolerance import HeartbeatMonitor

CPU = "cpu"
NO_RETRY = RetryPolicy(attempts=1, deadline=None)
INDEX_STATE = ("_idx", "_val", "_tau", "_dropped")
STORE_STATE = ("_idx", "_rows", "_tau")


def _corpus(rng, D, n, nnz=None):
    out = np.zeros((D, n), np.float32)
    nnz = nnz or n // 4
    for d in range(D):
        ii = rng.choice(n, nnz, replace=False)
        out[d, ii] = rng.uniform(-1, 1, nnz)
    return out


def lib(side):
    """The package of one side: ``"port"`` or ``"ref"``."""
    return T if side == "port" else J


def on(side) -> dict:
    """The keywords that put one side's entry point on the CPU."""
    return {"device": CPU} if side == "port" else {}


def other(side):
    return "ref" if side == "port" else "port"


def assert_same_state(got, want, keys=INDEX_STATE):
    """Names and the occupied prefix of every payload array, bit for bit."""
    assert list(got._names) == list(want._names)
    D = len(want._names)
    for k in keys:
        assert_bits(getattr(got, k)[:D], getattr(want, k)[:D])


# ---------------------------------------------------------------------------
# durability: snapshots
# ---------------------------------------------------------------------------


def test_snapshot_round_trip_sketch_index(tmp_path):
    rng = np.random.default_rng(0)
    idx = SketchIndex(m=64, n_buckets=128, slots=4, seed=9, device=CPU)
    V = _corpus(rng, 5, 1024)
    idx.add_many([f"v{d}" for d in range(5)], V)
    path = save_snapshot(idx, str(tmp_path), journal_seq=3)
    loaded, seq = load_snapshot(path, device=CPU)
    assert seq == 3
    assert loaded._names == idx._names and loaded._dim == idx._dim
    assert (loaded.m, loaded.n_buckets, loaded.slots, loaded.seed) == \
        (idx.m, idx.n_buckets, idx.slots, idx.seed)
    q = rng.normal(size=1024).astype(np.float32)
    assert idx.query(q) == loaded.query(q)   # bit-exact blocks


def test_snapshot_round_trip_matrix_store(tmp_path):
    rng = np.random.default_rng(1)
    st = MatrixSketchStore(32, dim=8, seed=5, device=CPU)
    st.add("A", rng.normal(size=(100, 8)).astype(np.float32))
    st.add("B", rng.normal(size=(100, 8)).astype(np.float32))
    loaded, _ = load_snapshot(save_snapshot(st, str(tmp_path)), device=CPU)
    np.testing.assert_array_equal(loaded.product("A", "B"),
                                  st.product("A", "B"))


def test_corrupt_snapshot_detected_and_quarantined(tmp_path):
    """A flipped payload byte fails the CRC; the newest intact snapshot
    is loaded instead and the corrupt one is moved aside."""
    rng = np.random.default_rng(2)
    idx = SketchIndex(m=32, n_buckets=64, seed=4, device=CPU)
    idx.add("a", rng.normal(size=256).astype(np.float32))
    old = save_snapshot(idx, str(tmp_path), journal_seq=1)
    idx.add("b", rng.normal(size=256).astype(np.float32))
    new = save_snapshot(idx, str(tmp_path), journal_seq=2)

    val = os.path.join(new, "val.npy")
    blob = bytearray(open(val, "rb").read())
    blob[-7] ^= 0xFF
    open(val, "wb").write(bytes(blob))

    with pytest.raises(SnapshotCorruptionError, match="CRC32"):
        load_snapshot(new, device=CPU)
    loaded, seq = load_latest_snapshot(str(tmp_path), device=CPU)
    assert seq == 1 and loaded._names == ["a"]          # fell back
    assert not os.path.exists(new)                      # quarantined aside
    assert os.path.exists(new + ".quarantined")
    assert list_snapshots(str(tmp_path)) == [old]       # quarantine hidden


def test_transient_read_failure_skips_without_quarantine(tmp_path,
                                                         monkeypatch):
    """A transient I/O failure on the newest snapshot skips it without
    quarantining it; once the failure clears it loads again."""
    rng = np.random.default_rng(42)
    idx = SketchIndex(m=32, n_buckets=64, seed=4, device=CPU)
    idx.add("a", rng.normal(size=256).astype(np.float32))
    old = save_snapshot(idx, str(tmp_path), journal_seq=1)
    idx.add("b", rng.normal(size=256).astype(np.float32))
    new = save_snapshot(idx, str(tmp_path), journal_seq=2)

    real_load = np.load

    def denied(path, *a, **k):
        if str(path).startswith(new):
            raise PermissionError(f"injected EACCES on {path}")
        return real_load(path, *a, **k)
    monkeypatch.setattr(np, "load", denied)

    with pytest.raises(SnapshotReadError, match="transient"):
        load_snapshot(new, device=CPU)
    loaded, seq = load_latest_snapshot(str(tmp_path), device=CPU)
    assert seq == 1 and loaded._names == ["a"]      # fell back past it
    assert os.path.exists(new)                      # not renamed aside
    assert not os.path.exists(new + ".quarantined")
    monkeypatch.undo()
    loaded, seq = load_latest_snapshot(str(tmp_path), device=CPU)
    assert seq == 2 and loaded._names == ["a", "b"]  # healthy again
    assert list_snapshots(str(tmp_path)) == [old, new]


def test_snapshot_version_and_manifest_checks(tmp_path):
    rng = np.random.default_rng(3)
    idx = SketchIndex(m=16, n_buckets=32, seed=2, device=CPU)
    idx.add("a", rng.normal(size=64).astype(np.float32))
    path = save_snapshot(idx, str(tmp_path))
    mpath = os.path.join(path, "manifest.json")
    manifest = json.load(open(mpath))
    manifest["format_version"] = 99
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(SnapshotCorruptionError, match="version"):
        load_snapshot(path, device=CPU)
    open(mpath, "w").write("{not json")
    with pytest.raises(SnapshotCorruptionError, match="manifest"):
        load_snapshot(path, device=CPU)


# ---------------------------------------------------------------------------
# durability: journal + recovery (the journal tests write with one package
# and read with the other as well)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_journal_replay_stops_at_corrupt_tail(tmp_path, writer):
    path = str(tmp_path / "j.wal")
    j = lib(writer).IngestJournal(path)
    j.append("add", {"name": "a"})
    j.append("add", {"name": "b"})
    j.close()
    with open(path, "a") as f:                 # crash mid-append
        f.write('{"seq": 3, "op": "add", "crc": 0, "bo')
    records, dropped = IngestJournal.read(path)
    assert [r[2]["name"] for r in records] == ["a", "b"]
    assert dropped == 1
    assert J.IngestJournal.read(path) == (records, dropped)
    # a fresh journal resumes numbering after the last good record
    j2 = IngestJournal(path)
    assert j2.seq == 2
    j2.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_journal_truncates_corrupt_tail_before_reappending(tmp_path, writer):
    """Reopening the live journal cuts a torn tail before appending, so
    an op acknowledged after recovery is not lost behind garbage."""
    path = str(tmp_path / "j.wal")
    j = lib(writer).IngestJournal(path)
    j.append("add", {"name": "a"})
    j.append("add", {"name": "b"})
    j.close()
    with open(path, "a") as f:                 # crash mid-append
        f.write('{"seq": 3, "op": "add", "crc": 0, "bo')
    j2 = lib(other(writer)).IngestJournal(path)  # reopen cuts the tail
    assert j2.seq == 2
    j2.append("add", {"name": "c"})            # acked post-recovery
    j2.close()
    for reader in (IngestJournal, J.IngestJournal):
        records, dropped = reader.read(path)
        assert dropped == 0
        assert [r[2]["name"] for r in records] == ["a", "b", "c"]


def test_recover_twice_never_loses_acked_ops(tmp_path):
    """Crash mid-append, recover, acknowledge more, crash, recover: every
    acknowledged op survives; only the torn tail is lost."""
    rng = np.random.default_rng(43)
    va, vb = (rng.normal(size=256).astype(np.float32) for _ in range(2))
    kw = dict(m=32, n_buckets=64, seed=3, device=CPU)
    dur = DurableSketchIndex(str(tmp_path), **kw)
    dur.add("a", va)
    dur.journal.close()
    with open(os.path.join(str(tmp_path), "journal.wal"), "a") as f:
        f.write('{"torn mid-append')           # first crash: torn tail
    rec1 = DurableSketchIndex.recover(str(tmp_path), **kw)
    assert rec1.dropped_tail == 1 and rec1.index._names == ["a"]
    rec1.add("b", vb)                          # acked after the torn tail
    rec1.journal.close()                       # second crash
    rec2 = DurableSketchIndex.recover(str(tmp_path), **kw)
    assert rec2.dropped_tail == 0
    assert rec2.index._names == ["a", "b"]     # no acked op lost
    q = rng.normal(size=256).astype(np.float32)
    assert rec2.query(q) == rec1.query(q)      # and bit-exact


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_journal_crc_rejects_tampered_record(tmp_path, writer):
    path = str(tmp_path / "j.wal")
    j = lib(writer).IngestJournal(path)
    j.append("add", {"name": "a"})
    j.append("add", {"name": "b"})
    j.close()
    lines = open(path).readlines()
    lines[1] = lines[1].replace('"name": "b"', '"name": "evil"')
    open(path, "w").writelines(lines)
    records, dropped = IngestJournal.read(path)
    assert [r[2]["name"] for r in records] == ["a"]     # stops at tamper
    assert dropped == 1


JOURNAL_BODIES = {
    "names": ("add", {"name": "a"}),
    "checkpoint": ("checkpoint", {"snapshot_seq": 7}),
    "escapes": ("add_many", {"names": ['x"y', "\\", "é", '{"data": "z'],
                             "matrix": None}),
    "merge": ("merge_from", {"params": {"kind": "sketch_index", "dim": None,
                                        "seed": 2557305653}, "names": [],
                             "idx": None, "val": None}),
}


@pytest.mark.parametrize("case", sorted(JOURNAL_BODIES))
def test_journal_lines_equal_reference(tmp_path, case):
    """A journal line is the reference's byte for byte (the body encoded
    once), and the reader that cuts the base64 payloads out of the parse
    returns the records the reference's reader returns, tampering
    detected as there."""
    from repro.serve.resilience import _enc as j_enc
    op, body = JOURNAL_BODIES[case]
    rng = np.random.default_rng(3)
    body = {k: (j_enc(rng.normal(size=(2, 5)).astype(np.float32))
                if v is None else v) for k, v in body.items()}
    line = IngestJournal._line(9, op, body)
    assert line == J.IngestJournal._line(9, op, body)
    path = str(tmp_path / "j.wal")
    with open(path, "w") as f:
        f.write(line + line.replace('"seq": 9', '"seq": 10'))
    got, want = IngestJournal.read(path), J.IngestJournal.read(path)
    assert got == want and len(got[0]) == 2 and got[1] == 0
    # a flipped payload character fails the CRC in both readers
    bad = line.replace('"data": "', '"data": "B', 1) if "data" in line \
        else line.replace('{"body": {"', '{"body": {"x', 1)
    with open(path, "w") as f:
        f.write(line + bad)
    assert IngestJournal.read(path) == J.IngestJournal.read(path)
    assert IngestJournal.read(path)[1] == 1
    # a bare carriage return splits a line for both readers
    with open(path, "w", newline="") as f:
        f.write(line[:20] + "\r" + line[20:] + line)
    assert IngestJournal.read(path) == J.IngestJournal.read(path)
    assert IngestJournal.read(path)[1] == 3


@pytest.mark.parametrize("layout", ["record_keys", "body_keys"])
def test_journal_reads_a_record_in_another_layout(tmp_path, layout):
    """A record not in the layout either package writes (the record's
    keys unsorted, or the body first but its own keys unsorted, so the
    bytes in place are not the canonical body) is checked against its
    re-encoded body, as the reference checks every record: accepted when
    the CRC matches, and a tampered one rejected."""
    import zlib
    from repro.serve.resilience import _enc as j_enc
    body = {"name": "a", "matrix": j_enc(np.arange(6, dtype=np.float32))}
    crc = zlib.crc32(json.dumps(body, sort_keys=True).encode()) & 0xFFFFFFFF
    if layout == "record_keys":
        line = json.dumps({"seq": 1, "op": "add", "crc": crc, "body": body})
    else:
        unsorted = {"name": "a", "matrix": dict(reversed(
            list(body["matrix"].items())))}
        line = '{"body": %s, "crc": %d, "op": "add", "seq": 1}' % (
            json.dumps(unsorted), crc)
        assert json.dumps(unsorted) != json.dumps(body, sort_keys=True)
    path = str(tmp_path / "j.wal")
    for tail, n_records in (("", 1), ("x", 0)):
        with open(path, "w") as f:
            f.write(line.replace('"a"', '"a' + tail + '"') + "\n")
        got = IngestJournal.scan_all(path)
        assert (len(got[0]), got[1]) == (n_records, 1 - n_records)
        assert IngestJournal.read(path) == J.IngestJournal.read(path)


@pytest.mark.parametrize("nbytes", [0, 1, 2, 3, 4, 999, 4096])
def test_base64_decode_by_tensor_ops_is_binascii(nbytes):
    """The tensor-op base64 decode (a card's route for large payloads)
    is bit-equal to ``base64.b64decode`` at every padding."""
    import base64
    from repro_torch.serve.resilience import _b64_on
    raw = np.random.default_rng(nbytes).integers(0, 256, nbytes, np.uint8)
    text = base64.b64encode(raw.tobytes()).decode("ascii")
    got = _b64_on(text, torch.device("cpu"))
    assert got.dtype == np.uint8 and got.tobytes() == raw.tobytes()


def _merge_ops(rng, n):
    """Rows ``w*`` whose two coordinate halves a peer merges in."""
    W = _corpus(rng, 4, n)
    half = n // 2
    left, right = W.copy(), W.copy()
    left[:, half:] = 0.0
    right[:, :half] = 0.0
    return left, right


def test_recover_bit_exact_after_crash(tmp_path):
    """Snapshot + journal replay rebuild the pre-crash index: dense,
    sparse and batch adds and a partition merge all ride the journal."""
    rng = np.random.default_rng(4)
    n = 1024
    dur = DurableSketchIndex(str(tmp_path), m=64, n_buckets=128, seed=7,
                             device=CPU)
    V = _corpus(rng, 4, n)
    dur.add("v0", V[0])
    dur.add_many(["v1", "v2"], V[1:3])
    dur.snapshot()
    nz = np.nonzero(V[3])[0]
    dur.add("v3", indices=nz, values=V[3][nz])
    left, right = _merge_ops(rng, n)
    dur.add_many([f"w{d}" for d in range(4)], left)     # left halves
    peer = SketchIndex(m=64, n_buckets=128, seed=7, device=CPU)
    peer.add_many([f"v{d}" for d in range(4)], np.zeros((4, n), np.float32))
    peer.add_many([f"w{d}" for d in range(4)], right)
    dur.merge_from(peer)

    q = rng.normal(size=n).astype(np.float32)
    before = dur.query(q)
    dur.journal.close()                                  # "crash"

    rec = DurableSketchIndex.recover(str(tmp_path), device=CPU)
    assert rec.replayed_ops == 3                         # post-snapshot tail
    assert rec.query(q) == before                        # bit-exact
    assert_same_state(rec.index, dur.index)


def test_recover_falls_back_past_corrupt_snapshot(tmp_path):
    rng = np.random.default_rng(5)
    dur = DurableSketchIndex(str(tmp_path), m=32, n_buckets=64, seed=3,
                             device=CPU)
    dur.add("a", rng.normal(size=256).astype(np.float32))
    dur.snapshot()
    dur.add("b", rng.normal(size=256).astype(np.float32))
    newest = dur.snapshot()
    q = rng.normal(size=256).astype(np.float32)
    before = dur.query(q)
    dur.journal.close()

    idxfile = os.path.join(newest, "idx.npy")
    blob = bytearray(open(idxfile, "rb").read())
    blob[-3] ^= 0x55
    open(idxfile, "wb").write(bytes(blob))

    rec = DurableSketchIndex.recover(str(tmp_path), device=CPU)
    # fell back to snapshot 1 and replayed the 'b' add from the journal
    assert rec.replayed_ops == 1
    assert rec.query(q) == before
    assert os.path.exists(newest + ".quarantined")


def test_recover_from_journal_only(tmp_path):
    """No snapshot: recovery replays the whole journal into a fresh index
    made from the given keywords."""
    rng = np.random.default_rng(6)
    kw = dict(m=32, n_buckets=64, seed=8, device=CPU)
    dur = DurableSketchIndex(str(tmp_path), **kw)
    V = _corpus(rng, 3, 512)
    dur.add_many(["a", "b", "c"], V)
    q = rng.normal(size=512).astype(np.float32)
    before = dur.query(q)
    dur.journal.close()
    rec = DurableSketchIndex.recover(str(tmp_path), **kw)
    assert rec.replayed_ops == 1 and rec.query(q) == before


def test_periodic_snapshot_every(tmp_path):
    rng = np.random.default_rng(7)
    dur = DurableSketchIndex(str(tmp_path), snapshot_every=2, m=16,
                             n_buckets=32, seed=1, device=CPU)
    for d in range(5):
        dur.add(f"v{d}", rng.normal(size=128).astype(np.float32))
    assert len(list_snapshots(os.path.join(str(tmp_path), "snapshots"))) == 2


def test_durable_add_takes_tensors(tmp_path):
    """Tensor inputs are copied to the host once: the journal holds the
    same bytes as for numpy inputs, and recovery is bit-exact."""
    rng = np.random.default_rng(44)
    V = _corpus(rng, 3, 256)
    kw = dict(m=32, n_buckets=64, seed=2, device=CPU)
    a = DurableSketchIndex(str(tmp_path / "np"), **kw)
    b = DurableSketchIndex(str(tmp_path / "t"), **kw)
    nz = np.flatnonzero(V[2])
    a.add_many(["x", "y"], V[:2])
    b.add_many(["x", "y"], torch.as_tensor(V[:2]))
    a.add("z", indices=nz, values=V[2][nz])
    b.add("z", indices=torch.as_tensor(nz), values=torch.as_tensor(V[2][nz]))
    for d in (a, b):
        d.journal.close()
    assert open(a.journal.path).read() == open(b.journal.path).read()
    assert_same_state(DurableSketchIndex.recover(str(tmp_path / "t"),
                                                 **kw).index, a.index)


# ---------------------------------------------------------------------------
# degraded-mode reads
# ---------------------------------------------------------------------------


def _resilient_index(rng, *, num_shards=4, D=6, n=2048, strict=False,
                     **kw):
    idx = ResilientSketchIndex(n, num_shards=num_shards, m=128,
                               n_buckets=256, seed=11, strict=strict,
                               retry=kw.pop("retry", NO_RETRY),
                               sleep=kw.pop("sleep", lambda s: None),
                               device=CPU, **kw)
    V = _corpus(rng, D, n, nnz=n // 2)
    idx.add_many([f"v{d}" for d in range(D)], V)
    return idx, V


def test_kill_shard_degraded_query_within_widened_bound():
    rng = np.random.default_rng(8)
    idx, V = _resilient_index(rng)
    q = rng.normal(size=2048).astype(np.float32)
    true = V.astype(np.float64) @ q

    healthy = idx.query(q)
    assert healthy.coverage == 1.0 and not healthy.degraded
    assert np.all(np.abs(healthy.estimates - true) <= healthy.bound)

    idx.kill_shard(1)
    idx.kill_shard(3)
    res = idx.query(q)
    assert res.degraded and res.down_shards == (1, 3)
    assert 0.0 < res.coverage < 1.0
    # the widened bound holds against the FULL answer
    assert np.all(np.abs(res.estimates - true) <= res.bound)
    assert np.all(res.lost_mass_bound > 0)
    np.testing.assert_allclose(res.bound,
                               res.sampling_bound + res.lost_mass_bound)


def test_kill_shard_degraded_all_pairs():
    rng = np.random.default_rng(9)
    idx, V = _resilient_index(rng, D=5)
    true = V.astype(np.float64) @ V.astype(np.float64).T
    idx.kill_shard(0)
    res = idx.all_pairs()
    assert res.estimates.shape == (5, 5) and res.degraded
    assert np.all(np.abs(res.estimates - true) <= res.bound)
    assert 0.0 < res.coverage < 1.0


def test_strict_mode_refuses_degraded_answers():
    rng = np.random.default_rng(10)
    idx, _ = _resilient_index(rng, strict=True)
    q = np.ones(2048, np.float32)
    idx.query(q)                         # healthy: fine in strict mode
    idx.kill_shard(2)
    with pytest.raises(DegradedServiceError, match="strict"):
        idx.query(q)
    res = idx.query(q, strict=False)     # a per-call override
    assert res.degraded and 2 in res.down_shards


def test_all_shards_down_raises():
    rng = np.random.default_rng(11)
    idx, _ = _resilient_index(rng, num_shards=2)
    idx.kill_shard(0)
    idx.kill_shard(1)
    with pytest.raises(ShardDownError, match="no surviving shards"):
        idx.query(np.ones(2048, np.float32))


def test_revived_shard_restores_full_coverage():
    rng = np.random.default_rng(12)
    idx, _ = _resilient_index(rng)
    idx.kill_shard(0)
    assert idx.query(np.ones(2048, np.float32)).coverage < 1.0
    idx.revive_shard(0)
    assert idx.query(np.ones(2048, np.float32)).coverage == 1.0


# ---------------------------------------------------------------------------
# guarded fan-out: retries, backoff, timeouts, heartbeats
# ---------------------------------------------------------------------------


def test_flaky_shard_call_retries_with_exponential_backoff():
    rng = np.random.default_rng(13)
    fails = {0: 2}                      # shard 0 fails its first 2 attempts

    def flaky(shard, fn):
        if fails.get(shard, 0) > 0:
            fails[shard] -= 1
            raise ConnectionError("injected flake")
        return fn()
    sleeps = []
    idx, V = _resilient_index(
        rng, call_wrapper=flaky, sleep=sleeps.append,
        retry=RetryPolicy(attempts=3, base_delay=0.1, max_delay=10.0,
                          deadline=None))
    res = idx.query(np.ones(2048, np.float32))
    assert not res.degraded             # retries absorbed the flakes
    assert sleeps == [0.1, 0.2]         # exponential backoff between tries


def test_exhausted_retries_mark_shard_down_but_serve_survivors():
    rng = np.random.default_rng(14)

    def dead(shard, fn):
        if shard == 2:
            raise ConnectionError("shard 2 is gone")
        return fn()
    sleeps = []
    idx, V = _resilient_index(
        rng, call_wrapper=dead, sleep=sleeps.append,
        retry=RetryPolicy(attempts=3, base_delay=0.5, max_delay=0.5,
                          deadline=None))
    q = rng.normal(size=2048).astype(np.float32)
    res = idx.query(q)
    assert res.down_shards == (2,) and res.degraded
    assert sleeps == [0.5, 0.5]         # capped at max_delay
    assert 2 in idx.down_shards()       # health remembers the failure
    true = V.astype(np.float64) @ q
    assert np.all(np.abs(res.estimates - true) <= res.bound)
    sleeps.clear()
    idx.query(q)                        # the dead shard is skipped
    assert sleeps == []


def test_timeout_marks_shard_down_without_retry():
    rng = np.random.default_rng(15)

    def hang(shard, fn):
        if shard == 1:
            raise TimeoutError("deadline exceeded")
        return fn()
    sleeps = []
    idx, _ = _resilient_index(
        rng, call_wrapper=hang, sleep=sleeps.append,
        retry=RetryPolicy(attempts=5, base_delay=0.1, deadline=None))
    res = idx.query(np.ones(2048, np.float32))
    assert res.down_shards == (1,)
    assert sleeps == []                 # no backoff into a hanging shard
    assert "TimeoutError" in idx.down_shards()[1]


def test_deadline_stops_retry_loop():
    rng = np.random.default_rng(16)
    clock = {"t": 0.0}

    def tick(shard, fn):
        clock["t"] += 3.0               # each attempt burns 3 s of clock
        raise ConnectionError("slow failure")
    idx, _ = _resilient_index(
        rng, call_wrapper=tick, sleep=lambda s: None,
        retry=RetryPolicy(attempts=10, base_delay=0.01, deadline=5.0),
        clock=lambda: clock["t"])
    with pytest.raises(ShardDownError):
        idx._shard_call(0, lambda: None)
    assert clock["t"] == 6.0            # 2 attempts, then the deadline


def test_heartbeat_eviction_and_revival():
    clock = {"t": 0.0}
    health = ShardHealth(3, timeout=10.0, clock=lambda: clock["t"])
    assert health.down_shards() == {}
    clock["t"] = 5.0
    health.beat(0)
    health.beat(1)
    clock["t"] = 12.0                   # shard 2 never beat after t=0
    down = health.down_shards()
    assert list(down) == [2] and "heartbeat" in down[2]
    health.beat(2)                      # a beat revives
    assert health.down_shards() == {}
    health.mark_down(1, "admin drain")
    assert list(health.down_shards()) == [1]
    health.beat(1)
    assert health.down_shards() == {}


def test_shard_health_accepts_injected_monitor():
    clock = {"t": 100.0}
    mon = HeartbeatMonitor(timeout=7.0)
    mon.beat(0, now=50.0)                # a stale beat from the manager
    health = ShardHealth(2, timeout=60.0, clock=lambda: clock["t"],
                         monitor=mon)
    assert health.monitor is mon
    assert health.timeout == 7.0         # the shared monitor's timeout wins
    down = health.down_shards()
    assert 0 in down and 1 not in down   # the stale beat is kept
    health.beat(0)
    assert health.down_shards() == {}


# ---------------------------------------------------------------------------
# ingest atomicity: a failed multi-shard write must not wedge the index
# ---------------------------------------------------------------------------


def test_partial_shard_add_rolls_back():
    rng = np.random.default_rng(21)
    idx, V = _resilient_index(rng, D=3)
    orig = idx._shards[2].add

    def exploding(name, sl, **kw):
        raise MemoryError("injected allocation failure")
    idx._shards[2].add = exploding
    v = rng.normal(size=2048).astype(np.float32)
    with pytest.raises(MemoryError):
        idx.add("new", v)
    assert len(idx) == 3
    assert [len(s) for s in idx._shards] == [3] * 4   # no shard kept it
    res = idx.query(np.ones(2048, np.float32))        # reads still work
    assert res.estimates.shape == (3,)
    idx._shards[2].add = orig
    idx.add("new", v)                  # the name is usable after the unwind
    assert len(idx) == 4 and idx.query(v).estimates.shape == (4,)


def test_partial_shard_add_many_rolls_back():
    rng = np.random.default_rng(22)
    idx, V = _resilient_index(rng, D=2)

    def exploding(names, sl):
        raise MemoryError("injected allocation failure")
    orig = idx._shards[3].add_many
    idx._shards[3].add_many = exploding
    W = rng.normal(size=(3, 2048)).astype(np.float32)
    with pytest.raises(MemoryError):
        idx.add_many(["x", "y", "z"], W)
    assert len(idx) == 2
    assert [len(s) for s in idx._shards] == [2] * 4
    idx._shards[3].add_many = orig
    idx.add_many(["x", "y", "z"], W)
    assert len(idx) == 5
    assert idx.query(np.ones(2048, np.float32)).estimates.shape == (5,)


def test_partial_matrix_store_add_rolls_back():
    rng = np.random.default_rng(23)
    ms = ResilientMatrixStore(200, 8, num_shards=4, m=32, retry=NO_RETRY,
                              device=CPU)
    A = rng.normal(size=(200, 8)).astype(np.float32)
    ms.add("A", A)

    def exploding(name, sl):
        raise MemoryError("injected allocation failure")
    orig = ms._shards[1].add
    ms._shards[1].add = exploding
    with pytest.raises(MemoryError):
        ms.add("B", A)
    assert len(ms) == 1
    assert [len(s) for s in ms._shards] == [1] * 4
    ms._shards[1].add = orig
    ms.add("B", A)                     # name reusable, store consistent
    assert ms.product("A", "B").estimates.shape == (8, 8)


# ---------------------------------------------------------------------------
# input hardening
# ---------------------------------------------------------------------------


def test_nan_ingest_rejected_by_default():
    idx = ResilientSketchIndex(256, num_shards=2, m=32, n_buckets=64,
                               retry=NO_RETRY, device=CPU)
    v = np.ones(256, np.float32)
    v[3] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        idx.add("bad", v)
    assert len(idx) == 0                # nothing partially ingested
    v[3] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        idx.add_many(["bad"], v[None, :])
    ms = ResilientMatrixStore(64, 4, num_shards=2, m=16, retry=NO_RETRY,
                              device=CPU)
    with pytest.raises(ValueError, match="non-finite"):
        ms.add("bad", np.full((64, 4), np.nan, np.float32))


def test_nan_ingest_sanitize_policy_zeroes():
    rng = np.random.default_rng(17)
    idx = ResilientSketchIndex(256, num_shards=2, m=64, n_buckets=128,
                               nonfinite="sanitize", retry=NO_RETRY,
                               device=CPU)
    v = rng.normal(size=256).astype(np.float32)
    v[7] = np.nan
    idx.add("a", v)
    res = idx.query(np.ones(256, np.float32))
    assert np.all(np.isfinite(res.estimates))
    clean = v.copy()
    clean[7] = 0.0
    ref = ResilientSketchIndex(256, num_shards=2, m=64, n_buckets=128,
                               retry=NO_RETRY, device=CPU)
    ref.add("a", clean)
    np.testing.assert_array_equal(
        res.estimates, ref.query(np.ones(256, np.float32)).estimates)


def test_resilient_index_input_errors():
    rng = np.random.default_rng(18)
    idx = ResilientSketchIndex(256, num_shards=2, m=32, n_buckets=64,
                               retry=NO_RETRY, device=CPU)
    with pytest.raises(ValueError, match="empty"):
        idx.query(np.ones(256, np.float32))
    idx.add("a", rng.normal(size=256).astype(np.float32))
    with pytest.raises(ValueError, match="duplicate"):
        idx.add("a", rng.normal(size=256).astype(np.float32))
    with pytest.raises(ValueError, match="coordinates"):
        idx.query(np.ones(100, np.float32))
    with pytest.raises(ValueError, match="coordinates"):
        idx.add("b", np.ones(100, np.float32))


def test_resilient_matrix_store_errors_and_degraded_product():
    rng = np.random.default_rng(19)
    ms = ResilientMatrixStore(200, 8, num_shards=4, m=64, seed=5,
                              retry=NO_RETRY, device=CPU)
    with pytest.raises(ValueError, match="empty"):
        ms.query(np.ones((200, 8), np.float32))
    A = rng.normal(size=(200, 8)).astype(np.float32)
    B = rng.normal(size=(200, 8)).astype(np.float32)
    ms.add("A", A)
    ms.add("B", B)
    with pytest.raises(ValueError, match="duplicate"):
        ms.add("A", A)
    with pytest.raises(ValueError, match="expected"):
        ms.add("C", rng.normal(size=(10, 8)).astype(np.float32))
    with pytest.raises(KeyError):
        ms.product("A", "nope")

    true = A.astype(np.float64).T @ B.astype(np.float64)
    ms.kill_shard(0)
    res = ms.product("A", "B")
    assert res.degraded and 0.0 < res.coverage < 1.0
    assert np.linalg.norm(res.estimates - true) <= float(res.bound)
    qres = ms.query(A)
    assert qres.estimates.shape == (2, 8, 8)
    assert np.linalg.norm(qres.estimates[1] - true) <= float(qres.bound[1])
    with pytest.raises(DegradedServiceError):
        ms.product("A", "B", strict=True)


# ---------------------------------------------------------------------------
# against the live reference: snapshots and journals across packages
# ---------------------------------------------------------------------------

N_X, D_X, M_X = 2048, 12, 64
INDEX_KW = dict(m=M_X, n_buckets=128, slots=4, seed=13)


@pytest.fixture(scope="module")
def x_data():
    rng = np.random.default_rng(31)
    return {"V": _corpus(rng, D_X, N_X, nnz=300),
            "mats": rng.normal(size=(3, 150, 6)).astype(np.float32),
            "q": rng.normal(size=N_X).astype(np.float32)}


@pytest.fixture(scope="module")
def x_built(x_data):
    """The same index and store in both packages (bit-equal blocks)."""
    out = {}
    for side in ("port", "ref"):
        idx = lib(side).SketchIndex(**INDEX_KW, **on(side))
        idx.add_many([f"r{d}" for d in range(D_X)], x_data["V"])
        st = lib(side).MatrixSketchStore(32, dim=6, seed=5, **on(side))
        for k, A in enumerate(x_data["mats"]):
            st.add(f"M{k}", A)
        out[side] = {"index": idx, "store": st}
    assert_same_state(out["port"]["index"], out["ref"]["index"])
    assert_same_state(out["port"]["store"], out["ref"]["store"], STORE_STATE)
    return out


@pytest.mark.parametrize("kind", ["index", "store"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_snapshot_loads_across_packages(tmp_path, x_built, writer, kind):
    """A snapshot either package writes loads in the other bit-equal:
    names, the payload arrays and the journal position; the manifests
    agree field for field."""
    src = x_built[writer][kind]
    path = lib(writer).save_snapshot(src, str(tmp_path / writer),
                                     journal_seq=5)
    reader = other(writer)
    loaded, seq = lib(reader).load_snapshot(path, **on(reader))
    assert seq == 5
    assert type(loaded).__name__ == type(src).__name__
    assert_same_state(loaded, src,
                      INDEX_STATE if kind == "index" else STORE_STATE)
    mirror = lib(reader).save_snapshot(x_built[reader][kind],
                                       str(tmp_path / reader), journal_seq=5)
    manifests = [json.load(open(os.path.join(p, "manifest.json")))
                 for p in (path, mirror)]
    assert manifests[0] == manifests[1]


def _durable_ops(dur, side, data, tmp):
    """The shared op sequence: a batch add, a dense add, a snapshot, a
    sparse add, a batch of left halves and the merge of their right
    halves from a peer."""
    V = data["V"]
    dur.add_many([f"r{d}" for d in range(6)], V[:6])
    dur.add("r6", V[6])
    dur.snapshot()
    nz = np.flatnonzero(V[7])
    dur.add("r7", indices=nz, values=V[7][nz])
    left, right = _merge_ops(np.random.default_rng(32), N_X)
    dur.add_many([f"w{d}" for d in range(4)], left)
    peer = lib(side).SketchIndex(**INDEX_KW, **on(side))
    peer.add_many([f"r{d}" for d in range(8)], np.zeros((8, N_X), np.float32))
    peer.add_many([f"w{d}" for d in range(4)], right)
    dur.merge_from(peer)


def _crash(dur, fault: str) -> None:
    """Close the journal; then tear its tail or flip a snapshot byte."""
    dur.journal.close()
    if fault == "torn_tail":
        with open(dur.journal.path) as f:
            last = f.readlines()[-1]
        with open(dur.journal.path, "a") as f:
            f.write(last[: len(last) // 2])
    elif fault == "corrupt_snapshot":
        snap = list_snapshots(os.path.join(dur.directory, "snapshots"))[-1]
        blob = bytearray(open(os.path.join(snap, "val.npy"), "rb").read())
        blob[-5] ^= 0x40
        open(os.path.join(snap, "val.npy"), "wb").write(bytes(blob))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_journal_recovers_across_packages(tmp_path, x_data, writer):
    """A durable index run in one package (snapshot, then a journal tail
    with a sparse add, a batch and a merge, and a torn record) recovers in
    the other bit-equal to the crashed index."""
    d = str(tmp_path / "durable")
    dur = lib(writer).DurableSketchIndex(d, **INDEX_KW, **on(writer))
    _durable_ops(dur, writer, x_data, tmp_path)
    _crash(dur, "torn_tail")
    reader = other(writer)
    rec = lib(reader).DurableSketchIndex.recover(d, **on(reader))
    assert (rec.replayed_ops, rec.dropped_tail) == (3, 1)
    assert rec.journal.seq == dur.journal.seq
    assert_same_state(rec.index, dur.index)
    rec.journal.close()


@pytest.mark.parametrize("fault", ["torn_tail", "corrupt_snapshot"])
def test_recover_equal_bits_across_packages(tmp_path, x_data, fault):
    """The same op sequence and fault in each package: both recoveries
    replay the same ops and end bit-equal to each other and to the
    crashed index."""
    rec = {}
    for side in ("port", "ref"):
        d = str(tmp_path / side)
        dur = lib(side).DurableSketchIndex(d, **INDEX_KW, **on(side))
        _durable_ops(dur, side, x_data, tmp_path)
        _crash(dur, fault)
        rec[side] = lib(side).DurableSketchIndex.recover(d, **INDEX_KW,
                                                         **on(side))
        assert_same_state(rec[side].index, dur.index)
        rec[side].journal.close()
    assert_same_state(rec["port"].index, rec["ref"].index)
    # a corrupt (only) snapshot: the whole journal replays, its
    # checkpoint marker aside
    want = (3, 1) if fault == "torn_tail" else (5, 0)
    for r in rec.values():
        assert (r.replayed_ops, r.dropped_tail) == want
    assert rec["port"].journal.seq == rec["ref"].journal.seq
    q = x_data["q"]
    assert_close(np.array([e for _, e in rec["port"].query(q)]),
                 np.array([e for _, e in rec["ref"].query(q)]))


# ---------------------------------------------------------------------------
# the departures from the reference, pinned
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def recovered(tmp_path_factory, x_data):
    """Both packages' indexes (head_h = 4) recovered from a snapshot alone,
    beside the pre-crash indexes."""
    out = {}
    for side in ("port", "ref"):
        d = str(tmp_path_factory.mktemp(side))
        dur = lib(side).DurableSketchIndex(d, **INDEX_KW, head_h=4,
                                           **on(side))
        dur.add_many([f"r{d}" for d in range(D_X)], x_data["V"])
        dur.snapshot()
        dur.journal.close()
        rec = lib(side).DurableSketchIndex.recover(d, **on(side))
        rec.journal.close()
        out[side] = (dur.index, rec.index)
    return out


def test_recovered_row_summaries_are_refreshed(recovered):
    """The port recomputes a loaded index's row summaries from its values
    and taus (and bumps the summary epoch), so they equal the pre-crash
    index's and discovery prunes on real ceilings; the reference leaves
    them at zero."""
    pre, rec = recovered["port"]
    for got, want in zip(rec.row_summaries(), pre.row_summaries()):
        assert_bits(got, want)
    assert np.all(pre.row_summaries()[0] > 0)
    assert rec.summary_epoch > 0
    assert rec.top_pairs(5).items == pre.top_pairs(5).items
    j_pre, j_rec = recovered["ref"]
    assert all(np.all(np.asarray(s) == 0) for s in j_rec.row_summaries())
    assert not all(np.all(np.asarray(s) == 0) for s in j_pre.row_summaries())


def test_recovered_bias_aware_answers_agree_across_packages(recovered,
                                                            x_data):
    """The head state is not in a snapshot (the reference's format): both
    packages' recovered indexes answer ``bias_aware`` alike, with no head
    correction, that is, as ``plain``."""
    q = x_data["V"][0] + 0.1 * x_data["q"]
    ans = {}
    for side in ("port", "ref"):
        rec = recovered[side][1]
        ans[side] = np.array([e for _, e in rec.query(q, mode="bias_aware")])
        plain = np.array([e for _, e in rec.query(q)])
        np.testing.assert_array_equal(ans[side], plain)
    assert_close(ans["port"], ans["ref"])


# ---------------------------------------------------------------------------
# against the live reference: degraded reads under the same kills
# ---------------------------------------------------------------------------

KILLS = [(), (1,), (1, 3), (0, 2, 3)]


@pytest.fixture(scope="module")
def resilient_pair():
    rng = np.random.default_rng(33)
    V = _corpus(rng, 16, N_X, nnz=N_X // 2)
    mats = rng.normal(size=(4, 200, 8)).astype(np.float32)
    out = {}
    for side in ("port", "ref"):
        L = lib(side)
        idx = L.ResilientSketchIndex(N_X, num_shards=4, m=M_X, n_buckets=128,
                                     seed=11, retry=L.RetryPolicy(
                                         attempts=1, deadline=None),
                                     **on(side))
        idx.add_many([f"v{d}" for d in range(16)], V)
        ms = L.ResilientMatrixStore(200, 8, num_shards=4, m=32, seed=5,
                                    retry=L.RetryPolicy(attempts=1,
                                                        deadline=None),
                                    **on(side))
        for k, A in enumerate(mats):
            ms.add(f"M{k}", A)
        out[side] = (idx, ms)
    queries = rng.normal(size=(2, N_X)).astype(np.float32)
    return out, queries, mats


def _kill(fanout, kills):
    for p in range(fanout.num_shards):
        fanout.revive_shard(p)
    for p in kills:
        fanout.kill_shard(p)


def _assert_degraded_equal(got, want):
    assert got.down_shards == want.down_shards
    assert got.names == want.names
    np.testing.assert_allclose(got.coverage, want.coverage, rtol=1e-6)
    assert_close(got.estimates, want.estimates)
    for f in ("bound", "sampling_bound", "lost_mass_bound"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("kills", KILLS, ids=lambda k: f"down{list(k)}")
def test_resilient_index_matches_reference(resilient_pair, kills):
    sides, queries, _ = resilient_pair
    res = {}
    for side, (idx, _) in sides.items():
        _kill(idx, kills)
        res[side] = [idx.query(q) for q in queries] + [idx.all_pairs()]
    for got, want in zip(res["port"], res["ref"]):
        _assert_degraded_equal(got, want)
    # the shard seeds are the reference's, as plain ints
    port_idx, ref_idx = sides["port"][0], sides["ref"][0]
    assert [s.seed for s in port_idx._shards] == \
        [int(s.seed) for s in ref_idx._shards]
    for ps, rs in zip(port_idx._shards, ref_idx._shards):
        assert_same_state(ps, rs)


@pytest.mark.parametrize("kills", KILLS, ids=lambda k: f"down{list(k)}")
def test_resilient_store_matches_reference(resilient_pair, kills):
    sides, _, mats = resilient_pair
    pairs = [("M0", "M1"), ("M2", "M3"), ("M1", "M1")]
    res = {}
    for side, (_, ms) in sides.items():
        _kill(ms, kills)
        res[side] = [ms.products(pairs), ms.product("M0", "M2"),
                     ms.query(mats[3])]
    for got, want in zip(res["port"], res["ref"]):
        _assert_degraded_equal(got, want)
