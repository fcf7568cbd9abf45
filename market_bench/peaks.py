"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, 700 W) and
the bytes and operations a kernel's call needs at its shapes.

A roofline bound counts each input byte read once and each output byte
written once; a K-padded book's masked bundles need only their mask read
(``chip_smoke.py``'s ``live_bound``).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(read_bytes: int, write_bytes: int, fp32_ops: int) -> float:
    """The larger of bytes over the HBM rate and operations over the float32
    peak, in seconds."""
    return max((read_bytes + write_bytes) / HBM_BYTES_PER_S, fp32_ops / FP32_OPS_PER_S)


def live_book_bound_s(rows: int, bundles: int, terms: int, valid: int, pools: int,
                      out_bytes: int) -> float:
    """One proxy-evaluation round over a K-padded vector-pi book: the valid
    bundles' (pool, quantity) terms and prices, every slot's mask byte, the
    price vector; out: ``out_bytes`` and one chosen index a row.  Operations:
    2K a valid bundle for its cost, 2 a slot for the selection."""
    read = 8 * terms * valid + 4 * valid + rows * bundles + 4 * pools
    ops = 2 * terms * valid + 2 * rows * bundles
    return bound_s(read, out_bytes + 4 * rows, ops)

