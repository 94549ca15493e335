"""Decode attention: a few query rows against a long padded KV cache.

``flash_attention_decode`` is the serving engine's attend. On CUDA tensors
it launches the hand-written Hopper kernel ``csrc/decode_attention.cu``;
on CPU tensors it runs ``decode_attention_reference``, the plain PyTorch
version of the same function. There is no other path: a CUDA call that
cannot build or launch the kernel raises.

The function is the JAX package's ``flash_attention_decode`` (a Pallas
kernel for the TPU): scores accumulated in f32 and scaled by 1/sqrt(d),
keys at index >= ``kv_lengths[b]`` masked, softmax, output in q's dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch

from k8s_dra_driver_tpu_torch.compute import _build

#: The kernel's limits: query rows per sequence and head dim.
MAX_Q_LEN = 8
MAX_HEAD_DIM = 256

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def _kernel(dtype: torch.dtype):
    """(launch entry for ``dtype``, cudaGetErrorString) from the library,
    with their ctypes signatures declared."""
    lib = _build.load("decode_attention")
    fn = getattr(lib, f"decode_attention_{_DTYPES[dtype]}")
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    err_str = lib.decode_attention_error_string
    if err_str.argtypes is None:
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
    return fn, err_str


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
    fn, err_str = _kernel(q.dtype)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kv_lengths.data_ptr(), out.data_ptr(), b, h, ql, kv_cap, d,
                 1.0 / math.sqrt(d), stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: cudaError "
                           f"{err} ({err_str(err).decode()})")
    flash_attention_decode.launches += 1
    return out


flash_attention_decode.launches = 0
