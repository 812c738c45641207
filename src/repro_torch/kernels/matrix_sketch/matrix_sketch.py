"""Wrapper of the CUDA batched matrix-product kernel
(``csrc/matrix_sketch.cu``).

:func:`matrix_products` (replaces ``matrix_products_pallas``): P pairs of
bucketized matrix sketches -> the (P, d_a, d_b) estimates of every
``A_p^T B_p`` in one launch.  The A side may have a leading dim of 1: one
query sketch against all P B-sides, read in place (batch stride 0), with
no copies.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor launches
the kernel or raises.  The wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import matrix_products_ref

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "repro_matrix_products": [_P, _P, _P, _P, _P, _P, _P, _I64, _INT, _I64,
                              _INT, _INT, _INT, _P],
}
# one block holds both sides' B*S ids and a match list of up to B*S
# entries (4 + 4 + 12 bytes a slot) in shared memory, beside the staged
# rows; Hopper gives a block 227 KiB, 64 bytes of it static here
SMEM_BYTES = 232448 - 64
MAX_SLOT_BYTES = 20
STAGE_ROWS = 32   # matched rows staged per round (kept in step with the .cu)


def _lib():
    return _build.load("matrix_sketch", _SIGNATURES)


def _check(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {dtype} tensor of "
                         f"shape {shape} on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def smem_bytes(B: int, S: int, da: int, db: int) -> int:
    """Dynamic shared memory of one block (the layout of the .cu)."""
    return B * S * MAX_SLOT_BYTES + STAGE_ROWS * (da + db) * 4


def matrix_products(a_idx, a_rows, a_p, b_idx, b_rows, b_p) -> torch.Tensor:
    """(Pa, B, S) int32 ids, (Pa, B, S, d_a) float32 rows and (Pa, B, S)
    float32 inclusion probabilities (1.0 at padding) for A, Pa in {1, P};
    (P, B, S), (P, B, S, d_b), (P, B, S) for B -> (P, d_a, d_b) float32."""
    if b_idx.device.type == "cpu":
        return matrix_products_ref(a_idx, a_rows, a_p, b_idx, b_rows, b_p)
    dev = b_idx.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if b_idx.ndim != 3 or a_idx.ndim != 3:
        raise ValueError(f"expected (P, B, S) ids, got {tuple(a_idx.shape)} "
                         f"and {tuple(b_idx.shape)}")
    P, B, S = b_idx.shape
    Pa = a_idx.shape[0]
    if Pa not in (1, P) or tuple(a_idx.shape[1:]) != (B, S):
        raise ValueError(f"A side {tuple(a_idx.shape)} does not pair with "
                         f"B side {tuple(b_idx.shape)} (leading dim 1 or P)")
    if a_rows.ndim != 4 or b_rows.ndim != 4:
        raise ValueError("rows must be (P, B, S, d)")
    da, db = a_rows.shape[-1], b_rows.shape[-1]
    if smem_bytes(B, S, da, db) > SMEM_BYTES:
        raise ValueError(f"B*S = {B * S} slots with d = {da}, {db} exceed "
                         "one block's shared memory")
    for t, what, dt, shape in (
            (a_idx, "a_idx", torch.int32, (Pa, B, S)),
            (a_rows, "a_rows", torch.float32, (Pa, B, S, da)),
            (a_p, "a_p", torch.float32, (Pa, B, S)),
            (b_idx, "b_idx", torch.int32, (P, B, S)),
            (b_rows, "b_rows", torch.float32, (P, B, S, db)),
            (b_p, "b_p", torch.float32, (P, B, S))):
        _check(t, what, dt, shape, dev)
    out = torch.empty((P, da, db), dtype=torch.float32, device=dev)
    lib = _lib()
    err = _build.launch_on(dev, lambda stream: lib.repro_matrix_products(
        a_idx.data_ptr(), a_rows.data_ptr(), a_p.data_ptr(), b_idx.data_ptr(),
        b_rows.data_ptr(), b_p.data_ptr(), out.data_ptr(), P, int(Pa == P), B,
        S, da, db, stream))
    _build.check(err, "matrix_products")
    matrix_products.launches += 1
    return out


matrix_products.launches = 0
