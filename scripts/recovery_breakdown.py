#!/usr/bin/env python
"""Where a durable index's recovery spends its time on a CUDA card, and
what each of the journal reader's fast paths saves.

The point is ``chip_smoke.py``'s recovery gate (its ``recovery_point``:
``benchmarks/degraded_serving.py``'s FULL_RECOVERY_POINT, 512 standard
normal rows over n = 2^15, m = 128, ingested in 8 batches, the snapshot
after the 7th).  The script prints one JSON object with the card's name
and power limit:

- ``variants``: the median of ROUNDS timings of ``recover`` as it ships
  and with each fast path replaced by the reference's way of doing the
  same step (``VARIANTS``), and of the rebuild (one ``add_many`` of all
  rows), each variant's ratio of rebuild over recovery beside it.  A
  round times every variant once, in an order that rotates from round to
  round, so every variant sees the same host.  Each variant's recovered
  index must be bit-equal to the shipped one's (exit 1 otherwise);
- ``steps``: the steps of recovery and of the rebuild, each the median of
  ROUNDS after a warm-up;
- ``decode``: base64 decode on the card against ``binascii`` at payloads
  of 2^12 to 2^24 characters, and the smallest size at which the card is
  faster (what ``_B64_ON_DEVICE`` is set from).

It exits 2 without a CUDA card.

    python scripts/recovery_breakdown.py
"""
from __future__ import annotations

import base64
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

ROUNDS = 9
DECODE_SIZES = [1 << k for k in range(12, 25, 2)]   # base64 characters


def _split_lines(data):
    pos = 0
    for line in data.splitlines(keepends=True):
        yield pos, pos + len(line)
        pos += len(line)


def _crc_reencoded(data, lo, hi, crc):
    canon = json.dumps(json.loads(data[lo:hi])["body"], sort_keys=True)
    return zlib.crc32(canon.encode()) & 0xFFFFFFFF == crc


# each fast path, replaced by the reference's way of doing its step
VARIANTS = {
    "shipped": {},
    "lines_by_splitlines": {"_lines": _split_lines},
    "crc_on_reencoded_body": {"_crc_ok": _crc_reencoded},
    "parse_whole_line": {"_loads": lambda data, lo, hi:
                         json.loads(data[lo:hi])},
    "decode_by_binascii": {"_B64_ON_DEVICE": float("inf")},
}
VARIANTS["reference_reader"] = {
    **VARIANTS["lines_by_splitlines"], **VARIANTS["crc_on_reencoded_body"],
    **VARIANTS["parse_whole_line"]}
VARIANTS["all_replaced"] = {k: v for d in VARIANTS.values()
                            for k, v in d.items()}


@contextlib.contextmanager
def patched(module, attrs: dict):
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def median_ms(fn, reps: int = ROUNDS) -> float:
    fn()
    return float(np.median([timed(fn) for _ in range(reps)]))


def main() -> None:
    if not torch.cuda.is_available():
        print("recovery_breakdown: needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    from repro_torch.serve import (DurableSketchIndex, SketchIndex,
                                   load_latest_snapshot)
    from repro_torch.serve import resilience as res

    dev = torch.device("cuda")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="recovery-",
                           dir=os.path.join(ROOT, "build"))
    out = {"point": {"D": cs.REC_POINT[0], "n": cs.REC_POINT[1],
                     "m": cs.REC_POINT[2], "batches": cs.REC_BATCHES},
           "rounds": ROUNDS}
    try:
        names, V, kw = cs.recovery_point(tmp, dev)
        batch = len(names) // cs.REC_BATCHES
        journal = os.path.join(tmp, "journal.wal")
        snaps = os.path.join(tmp, "snapshots")
        seq = load_latest_snapshot(snaps, device=dev)[1]

        def recover():
            r = DurableSketchIndex.recover(tmp, **kw)
            r.journal.close()
            return r.index

        def rebuild():
            SketchIndex(**kw).add_many(names, V)

        # -- the variants, in rotating order -----------------------------
        want = recover()
        names_v = list(VARIANTS)
        ts = {v: [] for v in names_v + ["rebuild"]}
        for v in names_v:
            with patched(res, VARIANTS[v]):
                got = recover()
            cs.check(got._names == want._names and all(
                np.array_equal(getattr(got, k)[:len(names)],
                               getattr(want, k)[:len(names)])
                for k in ("_idx", "_val", "_tau", "_dropped")),
                f"variant {v}: recovered index differs from the shipped one")
        rebuild()
        order = names_v + ["rebuild"]
        for r in range(ROUNDS):
            k = r % len(order)
            for v in order[k:] + order[:k]:
                if v == "rebuild":
                    ts[v].append(timed(rebuild))
                else:
                    with patched(res, VARIANTS[v]):
                        ts[v].append(timed(recover))
        rebuild_ms = float(np.median(ts["rebuild"]))
        out["rebuild_ms"] = rebuild_ms
        out["variants"] = {v: {"recover_ms": float(np.median(ts[v])),
                               "speedup": rebuild_ms / float(np.median(ts[v]))}
                           for v in names_v}

        # -- the steps ---------------------------------------------------
        tail = res.IngestJournal.scan_all(journal, after_seq=seq)[0]
        meta = tail[-1][2]["matrix"]
        M64 = res._dec(meta)

        def heads(rows):
            ix = SketchIndex(**kw)
            for r in range(rows):
                nz = np.flatnonzero(V[r])
                ix._set_head_row(0, nz, V[r, nz])
        out["steps"] = {
            "journal_scan_ms": median_ms(lambda: res.IngestJournal.scan_all(
                journal, after_seq=seq)),
            "payload_decode_on_card_ms": median_ms(lambda: res._dec(meta,
                                                                    dev)),
            "payload_decode_binascii_ms": median_ms(lambda: res._dec(meta)),
            "snapshot_load_ms": median_ms(lambda: load_latest_snapshot(
                snaps, device=dev)),
            "replayed_add_many_ms": median_ms(
                lambda: SketchIndex(**kw).add_many(names[:batch], M64)),
            "head_rows_64_ms": median_ms(lambda: heads(batch)),
            "head_rows_512_ms": median_ms(lambda: heads(len(names))),
            "journal_tail_bytes": os.path.getsize(journal),
            "payload_chars": len(meta["data"])}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- base64 decode: the card against binascii by payload size --------
    rng = np.random.default_rng(5)
    rows = []
    for chars in DECODE_SIZES:
        raw = rng.integers(0, 256, chars // 4 * 3, dtype=np.uint8)
        text = base64.b64encode(raw.tobytes()).decode("ascii")
        on_card = res._b64_on(text, dev)
        cs.check(np.array_equal(on_card, raw), f"card decode of {chars}")
        rows.append({"chars": chars,
                     "card_ms": median_ms(lambda: res._b64_on(text, dev)),
                     "binascii_ms": median_ms(
                         lambda: base64.b64decode(text))})
    faster = [r["chars"] for r in rows if r["card_ms"] < r["binascii_ms"]]
    out["decode"] = {"sizes": rows,
                     "card_faster_from_chars": min(faster) if faster
                     else None,
                     "threshold_chars": res._B64_ON_DEVICE}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
