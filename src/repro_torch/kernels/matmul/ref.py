"""Torch oracle for the tunable GEMM: C = alpha*A@B + beta*C."""

from __future__ import annotations


def gemm_reference(a, b, c, alpha=1.0, beta=1.0):
    """f32-accumulated reference.  ``b`` is always (K, N) here; layout
    variants are handled by the caller.  On a card this runs with TF32 off
    (PyTorch's default for matrix products), so the product is full f32."""
    acc = a.float() @ b.float()
    out = alpha * acc + beta * c.float()
    return out.to(c.dtype)
