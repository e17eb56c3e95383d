"""Operations and bytes of one attention launch, from its shape.

A shape is {"B", "H", "Tq", "Tk", "Dh"}.  Model FLOPs count the products
the layer needs: 4·B·H·Tq·Tk·Dh forward (Q·K^T and P·V), 8 backward (dV,
dP, dQ, dK).  A kernel's FLOPs are what a flash kernel must do, which is
the model's forward and, backward, the model's backward plus the
recomputed Q·K^T: 10·B·H·Tq·Tk·Dh.  Bytes count each input read once and
each output written once: forward q, k, v in, out (and in training the
f32 row log-sum-exp) out; backward q, k, v, out, dout and the f32
log-sum-exp in, dq, dk, dv out.
"""

from __future__ import annotations

ITEM = {"float32": 4, "bfloat16": 2}


def _bhqkd(s: dict) -> float:
    return float(s["B"] * s["H"] * s["Tq"] * s["Tk"] * s["Dh"])


def model_flops(kind: str, s: dict) -> float:
    return (4.0 if kind == "fwd" else 8.0) * _bhqkd(s)


def kernel_flops(kind: str, s: dict) -> float:
    return (4.0 if kind == "fwd" else 10.0) * _bhqkd(s)


def kernel_bytes(kind: str, s: dict, dtype: str) -> float:
    """``s["lse"]``: the forward also writes the row log-sum-exp (training)."""
    e = ITEM[dtype]
    q = s["B"] * s["H"] * s["Tq"] * s["Dh"]
    kv = s["B"] * s["H"] * s["Tk"] * s["Dh"]
    rows = s["B"] * s["H"] * s["Tq"] * 4
    if kind == "fwd":
        return float(e * (2 * q + 2 * kv) + (rows if s.get("lse") else 0))
    return float(e * (3 * q + 2 * kv) + rows + e * (q + 2 * kv))
