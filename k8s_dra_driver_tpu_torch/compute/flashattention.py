"""Attention kernels: whole-sequence flash attention and decode attention.

``flash_attention`` is exact attention over whole sequences, the compute
plane's single-device hot op; ``flash_attention_decode`` is the serving
engine's attend, a few query rows against a long padded KV cache. On CUDA
tensors each launches its hand-written Hopper kernel
(``csrc/flash_attention.cu``, ``csrc/decode_attention.cu``); on CPU
tensors each runs its plain PyTorch version (``reference_attention``,
``decode_attention_reference``). There is no other path: a CUDA call that
cannot build or launch its kernel raises.

The functions are the JAX package's ``flash_attention`` and
``flash_attention_decode`` (Pallas kernels for the TPU): scores accumulated
in f32 and scaled by 1/sqrt(d), the causal mask or the keys at index
>= ``kv_lengths[b]`` masked, softmax, output in q's dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch

from k8s_dra_driver_tpu_torch.compute import _build
from k8s_dra_driver_tpu_torch.compute.ringattention import (
    reference_attention,
)

#: The kernels' limits: query rows per sequence (decode) and head dim; the
#: flash kernel's head dims must also be multiples of HEAD_DIM_MULTIPLE.
MAX_Q_LEN = 8
MAX_HEAD_DIM = 256
HEAD_DIM_MULTIPLE = 16

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _c_entry(source: str, dtype: torch.dtype, argtypes: list):
    """(launch entry ``<source>_<dtype>``, its ``_error_string``) from
    ``lib<source>.so``, with their ctypes signatures declared."""
    lib = _build.load(source)
    fn = getattr(lib, f"{source}_{_DTYPES[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err_str = getattr(lib, f"{source}_error_string")
    if err_str.argtypes is None:
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
    return fn, err_str


def _raise_on(err: int, err_str, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: cudaError {err} "
                           f"({err_str(err).decode()})")


def _check_flash(q, k, v) -> None:
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q, k and v on different devices: "
                         f"{sorted(map(str, devices))}")
    b, h, seq, d = q.shape
    if k.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} must be q's {tuple(q.shape)} "
                         f"and v {tuple(v.shape)} [{b},{h},{seq},dv]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of "
                         f"{sorted(map(str, _DTYPES))}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    for name, dim in (("d", d), ("dv", v.shape[3])):
        if not (0 < dim <= MAX_HEAD_DIM and dim % HEAD_DIM_MULTIPLE == 0):
            raise ValueError(f"head dim {name}={dim} must be a multiple of "
                             f"{HEAD_DIM_MULTIPLE} in 1..{MAX_HEAD_DIM}")
    if b < 1 or h < 1:
        raise ValueError(f"empty batch or heads: q {tuple(q.shape)}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 256, block_k: int = 1024,
                    causal: bool = False) -> torch.Tensor:
    """[b, h, S, d] -> [b, h, S, dv] exact attention, optionally causal.

    q, k: [b, h, S, d]; v: [b, h, S, dv]; d and dv multiples of 16 up to
    256; one dtype, f32 or bf16. Returns [b, h, S, dv] in q's dtype.
    ``block_q`` and ``block_k`` are the JAX signature's block sizes: clamped
    to S, they must divide it, as there (else ValueError); the CUDA kernel
    walks the sequence in its own tiles.

    CUDA tensors go through the CUDA kernel on the tensors' device and
    current stream, counted in ``flash_attention.launches``; CPU tensors go
    through ``reference_attention``."""
    if q.dim() != 4:
        raise ValueError(f"q must be [b,h,S,d], got {tuple(q.shape)}")
    seq = q.shape[2]
    block_q, block_k = min(block_q, seq), min(block_k, seq)
    if seq < 1 or seq % block_q or seq % block_k:
        raise ValueError(f"block_q={block_q} and block_k={block_k} must "
                         f"divide seq {seq}")
    _check_flash(q, k, v)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries")
    b, h, _, d = q.shape
    dv = v.shape[3]
    p, i = ctypes.c_void_p, ctypes.c_int
    fn, err_str = _c_entry("flash_attention", q.dtype,
                           [p, p, p, p, i, i, i, i, i, ctypes.c_float, p])
    out = torch.empty((b, h, seq, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b * h, seq, d, dv, int(causal), 1.0 / math.sqrt(d), stream)
    _raise_on(err, err_str, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               kv_lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch decode attention with ragged KV lengths.

    q [b,h,ql,d] against padded caches k/v [b,h,cap,d]; keys at index
    >= kv_lengths[b] are masked. f32 einsum, mask, softmax, cast to q's
    dtype: the JAX package's ``xla_decode_attention``. The CPU path of
    ``flash_attention_decode`` and the kernel's oracle on the card."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (d ** 0.5)
    mask = (torch.arange(k.shape[2], device=k.device)[None, None, None, :]
            < kv_lengths.to(k.device)[:, None, None, None])
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def _check(q, k, v, kv_lengths) -> None:
    devices = {t.device for t in (q, k, v, kv_lengths)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and kv_lengths on different devices: "
                         f"{sorted(map(str, devices))}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k/v must be [b,h,ql,d] and [b,h,cap,d], "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    b, h, ql, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"both be [{b},{h},cap,{d}]")
    if kv_lengths.shape != (b,) or kv_lengths.dtype != torch.int32:
        raise ValueError(f"kv_lengths must be int32 [{b}], got "
                         f"{kv_lengths.dtype} {tuple(kv_lengths.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of "
                         f"{sorted(map(str, _DTYPES))}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not 1 <= ql <= MAX_Q_LEN or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"q_len {ql} must be in 1..{MAX_Q_LEN} and head "
                         f"dim {d} in 1..{MAX_HEAD_DIM}")
    if b < 1 or h < 1 or k.shape[2] < 1:
        raise ValueError(f"empty batch, heads or cache: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if not all(t.is_contiguous() for t in (q, k, v, kv_lengths)):
        raise ValueError("q, k, v and kv_lengths must be contiguous")


def flash_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_lengths: torch.Tensor,
                           block_k: int = 512) -> torch.Tensor:
    """Decode-shaped attention: short q against a long padded KV cache.

    q:          [b, h, q_len, d]   — q_len in 1..8, d in 1..256
    k, v:       [b, h, kv_cap, d]  — padded cache, valid prefix per batch
    kv_lengths: [b] int32          — valid keys per sequence (> 0)

    Returns [b, h, q_len, d] in q's dtype (f32 or bf16). ``block_k`` is the
    JAX signature's block size: it must divide ``kv_cap`` once clamped to
    it, as there; the CUDA kernel walks the cache in its own tiles.

    CUDA tensors go through the CUDA kernel on the tensors' device and
    current stream, counted in ``flash_attention_decode.launches``; CPU
    tensors go through ``decode_attention_reference``."""
    kv_cap = k.shape[2]
    block_k = min(block_k, kv_cap)
    if kv_cap % block_k:
        raise ValueError(f"block_k={block_k} must divide kv_cap {kv_cap}")
    _check(q, k, v, kv_lengths)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, kv_lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, ql, d = q.shape
    p, i = ctypes.c_void_p, ctypes.c_int
    fn, err_str = _c_entry("decode_attention", q.dtype,
                           [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p])
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kv_lengths.data_ptr(), out.data_ptr(), b, h, ql, kv_cap, d,
                 1.0 / math.sqrt(d), stream)
    _raise_on(err, err_str, "decode_attention")
    flash_attention_decode.launches += 1
    return out


flash_attention_decode.launches = 0
