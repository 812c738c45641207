"""Plain PyTorch version of the bucketized merge kernel
(``csrc/sketch_merge.cu``), and the merge plan it shares with the
payload-generic merge of ``engine.bucketized``.

Per row and bucket the 2S candidates are a's S slots, then b's.  A slot
is kept when its id is valid and its recomputed rank is below the row's
tau; a b slot whose id is also in a's bucket is a duplicate (a's copy
stands for it).  A kept candidate's output slot is the number of kept
candidates with a smaller id; those at slot >= S are dropped and counted.
Same math as ``repro.kernels.sketch_merge.ref.merge_bucketized_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import hash_unit
from repro_torch.core.sketches import INVALID_IDX, sampling_ranks, weight


def merge_plan(a_idx, a_w, b_idx, b_w, tau, seed):
    """(keep, pos), each (D, B, 2S), of the candidates of two (D, B, S)
    corpora with per-slot sampling weights ``a_w``/``b_w`` under the
    per-row ``tau`` (D,)."""
    D = a_idx.shape[0]
    tau3 = torch.as_tensor(tau, dtype=torch.float32,
                           device=a_idx.device).reshape(D, 1, 1)
    keep_a = ((a_idx != INVALID_IDX)
              & (sampling_ranks(a_w, hash_unit(seed, a_idx)) < tau3))
    dup = ((b_idx[..., :, None] == a_idx[..., None, :])
           & (a_idx != INVALID_IDX)[..., None, :]).any(dim=-1)
    keep_b = ((b_idx != INVALID_IDX) & ~dup
              & (sampling_ranks(b_w, hash_unit(seed, b_idx)) < tau3))
    keep = torch.cat([keep_a, keep_b], dim=2)
    key = torch.where(keep, torch.cat([a_idx, b_idx], dim=2),
                      torch.full_like(keep, INVALID_IDX, dtype=torch.int32))
    pos = (key[..., :, None] < key[..., None, :]).sum(dim=2)
    return keep, pos


def compact(keep, pos, slots: int, cand_idx, cand_pay):
    """Write each kept candidate to its slot ``pos`` < S: (out_idx
    (D, B, S) int32 with INVALID padding, out_pay (D, B, S, ...) float32
    with 0 padding, dropped (D,) int32)."""
    D, B, _ = keep.shape
    write = keep & (pos < slots)
    slot = torch.where(write, pos, torch.full_like(pos, slots))  # S: discard
    out_idx = torch.full((D, B, slots + 1), INVALID_IDX, dtype=torch.int32,
                         device=keep.device).scatter_(2, slot, cand_idx)
    rest = cand_pay.shape[3:]
    slot_p = slot.reshape(D, B, -1, *([1] * len(rest))).expand(cand_pay.shape)
    out_pay = torch.zeros((D, B, slots + 1, *rest), dtype=torch.float32,
                          device=keep.device).scatter_(2, slot_p, cand_pay)
    dropped = (keep & (pos >= slots)).sum(dim=(1, 2)).to(torch.int32)
    return (out_idx[:, :, :slots].contiguous(),
            out_pay[:, :, :slots].contiguous(), dropped)


def merge_bucketized_ref(a_idx, a_val, b_idx, b_val, tau, seed, *,
                         variant: str = "l2"):
    """Two (D, B, S) corpora and (D,) tau -> (out_idx, out_val, dropped
    (D,) int32): the entries lost to a full bucket in the merge."""
    a_val = a_val.to(torch.float32)
    b_val = b_val.to(torch.float32)
    keep, pos = merge_plan(a_idx, weight(a_val, variant), b_idx,
                           weight(b_val, variant), tau, seed)
    return compact(keep, pos, a_idx.shape[2],
                   torch.cat([a_idx, b_idx], dim=2).to(torch.int32),
                   torch.cat([a_val, b_val], dim=2))
