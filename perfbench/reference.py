"""The plain reference of decode attention, and its lower-precision control.

Plain PyTorch, imported by nothing of the program and importing nothing of
it: q [b, h, ql, d] against padded caches k [b, h, cap, d] and
v [b, h, cap, dv], the keys at index >= ``lens[b]`` masked; scores q.k in
f32 scaled by 1/sqrt(d), softmax, P V in f32, the output in q's dtype. The
arithmetic is a frozen copy of the port's ``decode_attention_reference``,
taken a few slots at a time (the control one) and only up to the block's
longest length, so that it fits beside the engine's slabs.

``tf32=True`` is the control: the same, with every operand of both
products rounded to TF32 (10 bits of mantissa, round to nearest even), the
precision a float32 product takes on the tensor cores when TF32 is on. It
is emulated by rounding, so that it is the same on any device and does not
depend on which library kernel a product would pick.
"""

from __future__ import annotations

import math

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32: 13 low mantissa bits cleared, rounding
    to nearest, ties to even. Infinities and NaNs are left as they are.
    It holds one copy of ``x`` and one temporary of its size at a time, so
    that a slot's cache fits beside the engine's slabs."""
    y = x.clone(memory_format=torch.contiguous_format)
    bits = y.view(torch.int32)
    t = bits >> 13
    t.bitwise_and_(1).add_(0x0FFF)
    bits.add_(t).bitwise_and_(~0x1FFF)
    del t
    finite = torch.isfinite(x)
    if not bool(finite.all()):
        y = torch.where(finite, y, x)
    return y


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lens: torch.Tensor, tf32: bool = False,
                     block: int = 8) -> torch.Tensor:
    """Decode attention of ``q`` over the first ``lens[b]`` keys of each
    slot's cache, ``block`` slots at a time (see the module docstring);
    with ``tf32`` the control."""
    b, h, ql, d = q.shape
    dv = v.shape[3]
    out = torch.empty((b, h, ql, dv), dtype=q.dtype, device=q.device)
    host_lens = [int(n) for n in lens.tolist()]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for b0 in range(0, b, block):
            b1 = min(b, b0 + block)
            n = max(1, max(host_lens[b0:b1]))
            qb = q[b0:b1].float()
            kb = k[b0:b1, :, :n].float()
            vb = v[b0:b1, :, :n].float()
            if tf32:
                qb, kb, vb = round_tf32(qb), round_tf32(kb), round_tf32(vb)
            s = torch.matmul(qb, kb.transpose(-1, -2)) / math.sqrt(d)
            keys = torch.arange(n, device=q.device)
            valid = keys[None, :] < lens[b0:b1].to(q.device)[:, None]
            s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
            p = torch.softmax(s, dim=-1)
            if tf32:
                p = round_tf32(p)
            out[b0:b1] = torch.matmul(p, vb).to(q.dtype)
            del qb, kb, vb, s, p
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out


def tf32_attend(q, k, v, lens, *_args, **_kwargs) -> torch.Tensor:
    """The control in the place of the program's attend: the reference
    with TF32-rounded operands, one slot at a time (its rounded copies
    have to fit beside the engine's slabs)."""
    return decode_attention(q, k, v, lens, tf32=True, block=1)


#: The controls that ``--control`` puts in the place of the program's attend.
CONTROLS = {"tf32": tf32_attend}
