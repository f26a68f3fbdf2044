"""The reference's products, in float32 or, for the control, in TF32.

TF32 keeps 10 of float32's 23 mantissa bits in a product's operands and
accumulates in float32. The control rounds each operand to TF32 (to
nearest) before a float32 product, so it computes in TF32 whatever the
card's cuBLAS settings (an environment may pin TF32 off); the gradient
passes the rounding unchanged (only the forward products round)."""

from __future__ import annotations

from contextlib import contextmanager

import torch

_STATE = {"tf32": False}


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to TF32's 10 mantissa bits (to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _operand(x: torch.Tensor) -> torch.Tensor:
    if not _STATE["tf32"] or x.dtype != torch.float32:
        return x
    return x + (to_tf32(x.detach()) - x).detach()


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _operand(a) @ _operand(b)


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bmm(_operand(a), _operand(b))


@contextmanager
def tf32(on: bool):
    """The reference's products in TF32 inside the block (the control),
    with the card's own TF32 switch set the same way."""
    prev = (_STATE["tf32"], torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    _STATE["tf32"] = on
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (_STATE["tf32"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
