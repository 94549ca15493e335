"""Attention kernels: whole-sequence flash attention and decode attention.

``flash_attention`` is exact attention over whole sequences, the compute
plane's single-device hot op; ``flash_attention_decode`` is the serving
engine's attend, a few query rows against a long padded KV cache. On CUDA
tensors each launches a hand-written Hopper kernel (``csrc/*.cu``); on CPU
tensors each runs its plain PyTorch version (``reference_attention``,
``decode_attention_reference``). There is no other path: a CUDA call that
cannot build or launch its kernel raises.

The functions are the JAX package's ``flash_attention`` and
``flash_attention_decode`` (Pallas kernels for the TPU), and take every
input those take: q, k and v each f32, bf16 or f16, in any mix, and any
head dims d and dv. Scores are q.k accumulated in f32 (every one of the
three types converts to f32 exactly, so this is the product in the
promoted type) and scaled by 1/sqrt(d); the causal mask or the keys at
index >= ``kv_lengths[b]`` are masked; softmax; p is rounded to v's dtype
for P V, which accumulates in f32; the output is in q's dtype.

On the card each wrapper picks a route by dtypes and head dims (head dims
zero-padded to the next multiple of 16 where a route says so). Flash has
three:

- tuned: q, k and v of one dtype, bf16 or f16, and d, dv <=
  TUNED_HEAD_DIM (the ``wgmma``/TMA path, padded head dims);
- wide: q, k and v all bf16 or all f16, padded d <= WIDE_MAX_D and dv <=
  WIDE_MAX_DV, one of them over TUNED_HEAD_DIM (DeepSeek-V3's absorbed
  MLA, 576/512): the tensor-core kernel of ``csrc/wide_attention.cuh``, 64
  query rows a tile with dv split between two warpgroups;
- any: everything else (all-f32 calls, q in a dtype apart from the one K
  and V share, K and V in different dtypes, head dims past the wide
  route's), at any head dims and in any mix of dtypes: the tensor-core
  kernels of ``csrc/cluster_flash.cuh`` (built by ``cluster_flash_q32.cu``
  and ``cluster_flash_q16.cu``), each operand copied in its own dtype, a
  16-bit one entering its products once (it is exact in TF32) and an f32
  one as hi and lo (3xTF32: hi.hi + hi.lo + lo.hi, f32-accurate); p
  rounded to V's dtype where V is 16-bit; a cluster of CTAs that split d
  between them, sum their partial scores through distributed shared
  memory and take 256 columns of dv each (one CTA a slice, computing the
  scores itself, where d is at most 128; ``cluster_flash_plan``), padded
  head dims.

Decode has five (``decode_route`` says which a call takes):

- tuned: K and V of one dtype, f32, bf16 or f16, d, dv <= TUNED_HEAD_DIM,
  rows of whole 16-byte chunks on 16-byte boundaries and q in any dtype
  (the ring kernel, built for the cache's dtype, reading q and writing out
  in q's: bulk copies of K and V tiles into shared memory, 1 or 2 chunks
  of a row a lane, with the cache split across blocks when b * h would
  leave SMs idle, ``tuned_decode_tile``, ``tuned_decode_splits``);
- wide: q, k and v all bf16 or all f16, d or dv over TUNED_HEAD_DIM up to
  padded WIDE_MAX_D and WIDE_MAX_DV: the wide kernel, every query row in
  one call, the cache split across blocks (``wide_decode_splits``), then
  the splits merged;
- f32: q, k and v all f32, d or dv over TUNED_HEAD_DIM up to the same
  dims: the tensor-core decode kernel of ``csrc/f32tc_attention.cuh``,
  each f32 product as three TF32 products, 64 query rows a tile, every
  query row in one call, the cache split across blocks
  (``f32_decode_splits``), then the splits merged;
- mixed: q in one dtype and K and V sharing another, d or dv over
  TUNED_HEAD_DIM up to the same dims: the same body built for 16-bit q or
  K and V (``csrc/mixed_decode.cu``);
- stream: the rest (K and V in different dtypes, rows the ring kernel
  does not take, such as d = 66 in 16 bits or an odd d in f32, a cache off
  a 16-byte boundary, head dims past the wide, f32 and mixed routes'): the
  byte-streaming kernel of ``csrc/stream_decode.cu``, which reads each
  valid K and V row once through a ring of bulk copies (of the 16-byte
  chunks around each span where a row is not whole chunks or the cache
  starts off a 16-byte boundary), takes every query row in one call, up to
  STREAM_ROWS a block, and splits the cache across blocks
  (``stream_decode_plan``), then merges the splits.

The tuned decode (the ring kernel) launches once per group of up to
MAX_Q_LEN query rows (its merge, where it splits the cache, counts as part
of its launch); every other route once a call.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from k8s_dra_driver_tpu_torch.compute import _build
from k8s_dra_driver_tpu_torch.compute.ringattention import (
    reference_attention,
)

#: Query rows per decode launch; the head dims up to which a call whose
#: q, k and v share a dtype takes the tuned kernels; the multiple to which
#: the flash wrapper pads head dims for them.
MAX_Q_LEN = 8
TUNED_HEAD_DIM = 256
HEAD_DIM_MULTIPLE = 16
#: The wide route's largest padded head dims; its query rows and keys per
#: tile; the least keys of one split of the decode cache, and the blocks an
#: SM that the split count aims for.
WIDE_MAX_D = 576
WIDE_MAX_DV = 512
WIDE_ROWS = 64
WIDE_KEYS = 32
WIDE_SPLIT_MIN_KEYS = 256
WIDE_BLOCKS_PER_SM = 1
#: The tuned decode's ring kernel: the bytes of one stage of its ring (a
#: tile of K rows and one of V rows), the least keys of one split of the
#: cache, and the blocks an SM that the split count aims for (two blocks'
#: rings fit an SM's shared memory).
TUNED_STAGE_BYTES = 32 * 1024
TUNED_SPLIT_MIN_KEYS = 256
TUNED_BLOCKS_PER_SM = 2
#: The f32 and mixed decode: its query rows and keys per tile; the output
#: columns one block takes (dv past them goes to more blocks); the least
#: keys of one split of the cache, and the blocks an SM that the split
#: count aims for (one is resident at a time; 3 ran fastest at
#: absorbed MLA's shape on an H100, ``chip_ab.py f32-splits``).
F32_ROWS = 64
F32_KEYS = 64
F32_DV_CHUNK = 256
F32_SPLIT_MIN_KEYS = 256
F32_BLOCKS_PER_SM = 3

#: The any-dtype flash (``csrc/cluster_flash.cuh``): the output columns
#: one CTA of a cluster takes (a dv of at most half of them takes one CTA
#: of that half), the most CTAs a cluster, and the columns of d in one of a
#: CTA's panel groups.
CLUSTER_DV_COLS = 256
CLUSTER_MAX_CTAS = 8
CLUSTER_GROUP_COLS = 128
#: The any-dtype decode (``csrc/stream_decode.cu``): query rows a block, the
#: most keys a tile, the ring's stages, a block's shared memory at one and
#: at two blocks an SM, and the least keys of one split of the cache.
STREAM_ROWS = 8
STREAM_MAX_TILE = 64
STREAM_STAGES = 3
STREAM_SMEM_ONE = 232448
STREAM_SMEM_TWO = 113 * 1024
STREAM_SPLIT_MIN_KEYS = 256
#: The any-dtype decode's split count aims for this many blocks for each
#: block slot of the card (more, shorter splits even out ragged lengths; 4
#: ran fastest of 1, 2 and 4 at every row of ``chip_ab.py stream-splits``
#: on an H100).
STREAM_WAVES = 4

#: Each dtype's suffix of a tuned kernel's C entry and its code in the
#: entries that take a dtype at run time; the dtypes each source's tuned
#: kernel takes.
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TUNED = {"decode_attention": tuple(_DTYPES),
          "flash_attention": (torch.bfloat16, torch.float16)}
_WIDE = (torch.bfloat16, torch.float16)
#: guards the wrappers' launch counts (a read-modify-write)
_LAUNCH_COUNT_MU = threading.Lock()


def _c_entry(source: str, variant: str, argtypes: list):
    """(launch entry ``<source>_<variant>``, its ``_error_string``) from
    ``lib<source>.so``, with their ctypes signatures declared."""
    lib = _build.load(source)
    fn = getattr(lib, f"{source}_{variant}")
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


def _check_dtypes(q, k, v) -> None:
    if any(t.dtype not in _DTYPES for t in (q, k, v)):
        raise ValueError(f"q, k and v must each be one of "
                         f"{sorted(map(str, _DTYPES))}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")


def tuned_kernel_takes(source: str, q, k, v, d: int, dv: int) -> bool:
    """Whether a CUDA call goes to the tuned kernel of ``source``
    (``"decode_attention"`` or ``"flash_attention"``): one dtype for k and
    v that the kernel is built for, head dims ``d`` and ``dv`` (the flash
    wrapper's padded ones) up to TUNED_HEAD_DIM; in flash, q in that dtype
    too; in decode, q in any dtype where the ring kernel takes the cache
    (``ring_kernel_takes``)."""
    if not (k.dtype == v.dtype and k.dtype in _TUNED[source]
            and max(d, dv) <= TUNED_HEAD_DIM):
        return False
    if source == "decode_attention":
        return ring_kernel_takes(k, v, d, dv)
    return q.dtype == k.dtype


def ring_kernel_takes(k, v, d: int, dv: int) -> bool:
    """Whether the tuned decode's ring kernel takes a cache ``k``, ``v``
    (one dtype, head dims ``d``, ``dv`` up to TUNED_HEAD_DIM): rows of
    whole 16-byte chunks (``tuned_decode_tile``), and k and v on 16-byte
    boundaries for its bulk copies."""
    return (tuned_decode_tile(k.dtype, d, dv) > 0
            and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)


def wide_kernel_takes(q, k, v, d: int, dv: int) -> bool:
    """Whether a CUDA call that the tuned kernel does not take goes to the
    wide kernels (either function): q, k and v all bf16 or all f16, padded
    head dims ``d`` <= WIDE_MAX_D and ``dv`` <= WIDE_MAX_DV, one of them
    over TUNED_HEAD_DIM."""
    return (q.dtype == k.dtype == v.dtype and q.dtype in _WIDE
            and TUNED_HEAD_DIM < max(d, dv) and d <= WIDE_MAX_D
            and dv <= WIDE_MAX_DV)


def f32_kernel_takes(q, k, v, d: int, dv: int) -> bool:
    """One of ``decode_route``'s tests (no flash call reads it: the
    any-dtype flash takes every all-f32 call): q, k and v all f32 and
    padded head dims ``d`` <= WIDE_MAX_D and ``dv`` <= WIDE_MAX_DV, which
    the f32 decode kernel takes where ``d`` or ``dv`` is over
    TUNED_HEAD_DIM."""
    return (q.dtype == k.dtype == v.dtype == torch.float32
            and d <= WIDE_MAX_D and dv <= WIDE_MAX_DV)


def mixed_kernel_takes(q, k, v, d: int, dv: int) -> bool:
    """One of ``decode_route``'s tests (no flash call reads it: the
    any-dtype flash takes every mix): k and v of one dtype, q of another,
    and padded head dims ``d`` <= WIDE_MAX_D and ``dv`` <= WIDE_MAX_DV,
    which the mixed decode kernel takes where ``d`` or ``dv`` is over
    TUNED_HEAD_DIM."""
    return (k.dtype == v.dtype != q.dtype and d <= WIDE_MAX_D
            and dv <= WIDE_MAX_DV)


def f32_decode_splits(b: int, h: int, ql: int, kv_cap: int, dv: int,
                      sms: int) -> tuple[int, int]:
    """(splits, keys per split) of the f32 decode kernel's cache range, for
    padded value dim ``dv``.

    Each of the b * h * ceil(ql / F32_ROWS) row tiles, times the
    ceil(dv / F32_DV_CHUNK) chunks of its output columns, is split so that
    the grid holds about F32_BLOCKS_PER_SM blocks for each of ``sms`` SMs,
    but no split has fewer than F32_SPLIT_MIN_KEYS keys of the cache (each
    costs a partial's write and read). A split is a whole number of
    F32_KEYS tiles. From the shapes alone: the lengths are on the device,
    and reading them would wait for it."""
    tiles = -(-kv_cap // F32_KEYS)
    blocks = b * h * -(-ql // F32_ROWS) * -(-dv // F32_DV_CHUNK)
    want = -(-F32_BLOCKS_PER_SM * sms // blocks)
    most = max(1, tiles * F32_KEYS // F32_SPLIT_MIN_KEYS)
    split_keys = -(-tiles // max(1, min(want, most))) * F32_KEYS
    return -(-kv_cap // split_keys), split_keys


def wide_decode_splits(b: int, h: int, ql: int, kv_cap: int,
                       sms: int) -> tuple[int, int]:
    """(splits, keys per split) of the wide decode kernel's cache range.

    Each of the b * h * ceil(ql / WIDE_ROWS) row tiles is split so that
    the grid holds about WIDE_BLOCKS_PER_SM blocks for each of ``sms`` SMs,
    but no split has fewer than WIDE_SPLIT_MIN_KEYS keys of the cache (each
    costs a Q tile's load and a partial's write and read). A split is a
    whole number of WIDE_KEYS tiles. From the shapes alone: the lengths are
    on the device, and reading them would wait for it."""
    tiles = -(-kv_cap // WIDE_KEYS)
    blocks = b * h * -(-ql // WIDE_ROWS)
    want = -(-WIDE_BLOCKS_PER_SM * sms // blocks)
    most = max(1, tiles * WIDE_KEYS // WIDE_SPLIT_MIN_KEYS)
    split_keys = -(-tiles // max(1, min(want, most))) * WIDE_KEYS
    return -(-kv_cap // split_keys), split_keys


def tuned_decode_tile(dtype: torch.dtype, d: int, dv: int) -> int:
    """Keys per tile of the tuned decode's ring kernel for a cache in
    ``dtype`` with head dims ``d`` and ``dv`` (each <= TUNED_HEAD_DIM), or
    0 where the kernel does not take it (the any-dtype decode does): K's or
    V's row not a whole number of 16-byte chunks, or more than 64 of them.
    A key takes 8, 16 or 32 lanes, each one chunk of its K row and one of
    its V row, or, for a row of 33-64 chunks (f32 at 129-256), 32 lanes of
    two chunks each; a tile is TUNED_STAGE_BYTES over two rows of that many
    chunks (16 keys at 256 in f32). (The kernel also needs k and v on
    16-byte boundaries; the wrapper checks.)"""
    size = dtype.itemsize
    if (d * size) % 16 or (dv * size) % 16:
        return 0
    chunks = max(d, dv) * size // 16
    if chunks > 64:
        return 0
    lanes = 8 if chunks <= 8 else 16 if chunks <= 16 else 32
    per_lane = 1 if chunks <= 32 else 2
    return TUNED_STAGE_BYTES // (2 * 16 * lanes * per_lane)


def tuned_decode_splits(b: int, h: int, kv_cap: int, tile: int,
                        sms: int) -> tuple[int, int]:
    """(splits, keys per split) of the ring kernel's cache range, for
    ``tile`` keys a tile (``tuned_decode_tile``).

    Each of the b * h caches is split so that the grid holds about
    TUNED_BLOCKS_PER_SM blocks for each of ``sms`` SMs, but no split has
    fewer than TUNED_SPLIT_MIN_KEYS keys of the cache, and a split is a
    whole number of tiles; one split (no merge) once b * h fills the SMs.
    From the shapes alone: the lengths are on the device, and reading them
    would wait for it."""
    tiles = -(-kv_cap // tile)
    want = -(-TUNED_BLOCKS_PER_SM * sms // (b * h))
    most = max(1, tiles * tile // TUNED_SPLIT_MIN_KEYS)
    split_keys = -(-tiles // max(1, min(want, most))) * tile
    return -(-kv_cap // split_keys), split_keys


def cluster_flash_plan(d: int, dv: int) -> tuple[int, int, int]:
    """(CTAs a cluster, d panel groups a CTA, 32-column V panels a CTA)
    of the any-dtype flash kernel for padded head dims ``d`` and ``dv``.

    A CTA takes CLUSTER_DV_COLS columns of dv (8 panels; 4 where dv is at
    most half of that, with one CTA); a cluster takes as many CTAs as dv has
    such slices, at most CLUSTER_MAX_CTAS (past that a query tile takes one
    cluster item per CLUSTER_MAX_CTAS slices). The cluster's CTAs split d
    between them in groups of CLUSTER_GROUP_COLS columns, the same count of
    groups each (those wholly past d are skipped), so that each computes a
    partial of S once per key tile, and the partials are summed. Where d is
    one group or less, one CTA takes each slice of dv and computes S itself:
    the exchange of partials cost more than S of so narrow a d (at 64/640 in
    bf16 on an H100, 1.47 ms in clusters of 3 against 0.85, ``chip_ab.py
    cluster-parts``)."""
    vp = 4 if dv <= CLUSTER_DV_COLS // 2 else 8
    cluster = 1 if vp == 4 or d <= CLUSTER_GROUP_COLS else min(
        CLUSTER_MAX_CTAS, -(-dv // CLUSTER_DV_COLS))
    groups = -(-d // (cluster * CLUSTER_GROUP_COLS))
    return cluster, groups, vp


def stream_decode_smem(tile: int, rows: int, d: int, dv: int, k_size: int,
                       v_size: int, pad: int = 0) -> int:
    """Shared-memory bytes of one block of the any-dtype decode kernel:
    STREAM_STAGES stages of ``tile`` keys' K and V rows (``k_size`` and
    ``v_size`` bytes an element, each span on 16 bytes and ``pad`` bytes
    longer, 16 where a span is copied as the 16-byte chunks around it,
    ``stream_decode_pad``), its barriers, q of ``rows`` query rows as f32
    (each row padded to a multiple of 8 where ``pad``) and O of each of its
    key groups as f32 (O's dv rounded up to 4; as many groups of dv / 4
    threads as its 256 consumer threads hold), two buffers of the tile's
    scores for 8 rows, and 8 rows' corrections, max and denominator
    (``stream_decode.cu``'s layout)."""
    r16 = lambda x: -(-x // 16) * 16  # noqa: E731
    stage = r16(tile * d * k_size) + r16(tile * dv * v_size) + 2 * pad
    dq = -(-d // 8) * 8 if pad else d   # q's row, whole float4s of chunks
    dvo = -(-dv // 4) * 4
    groups = max(1, 256 // (dvo // 4))
    return (STREAM_STAGES * stage + r16(2 * STREAM_STAGES * 8)
            + r16(rows * dq * 4) + r16(groups * rows * dvo * 4)
            + 2 * tile * 8 * 4 + 4 * 8 * 4)


@functools.lru_cache(maxsize=4096)
def stream_decode_plan(b: int, h: int, ql: int, kv_cap: int, d: int, dv: int,
                       k_size: int, v_size: int, sms: int,
                       pad: int = 0) -> tuple[int, int, int, int]:
    """(query rows a block, keys a tile, splits, keys per split) of the
    any-dtype decode kernel, for K and V elements of ``k_size`` and
    ``v_size`` bytes and stage buffers ``pad`` bytes longer
    (``stream_decode_pad``).

    A block takes up to STREAM_ROWS query rows (every row of the call goes
    to one launch, a grid dimension over groups of rows) and a tile of up to
    STREAM_MAX_TILE keys (a multiple of 8, the consumer warps, once it has
    8), the most that fit STREAM_SMEM_TWO (two blocks an SM) with at least
    8 keys, else STREAM_SMEM_ONE with fewer rows a block if need be. The
    cache of each (b, h, group of rows) is split so that the grid holds
    about STREAM_WAVES blocks for each block slot of ``sms`` SMs, but no
    split has fewer than STREAM_SPLIT_MIN_KEYS keys, and a split is a whole
    number of tiles. From the shapes alone: the lengths are on the device,
    and reading them would wait for it. Head dims whose rows do not fit one
    key a tile raise ValueError."""
    def fit(budget: int, rows: int) -> int:
        tile = STREAM_MAX_TILE
        while tile and stream_decode_smem(tile, rows, d, dv, k_size,
                                          v_size, pad) > budget:
            tile -= 1
        return tile - tile % 8 if tile >= 8 else tile

    rows = min(ql, STREAM_ROWS)
    tile, per_sm = fit(STREAM_SMEM_TWO, rows), 2
    if tile < min(8, kv_cap):
        tile, per_sm = fit(STREAM_SMEM_ONE, rows), 1
        while not tile and rows > 1:
            rows = -(-rows // 2)
            tile = fit(STREAM_SMEM_ONE, rows)
    if not tile:
        raise ValueError(f"head dims d={d}, dv={dv} are too wide for the "
                         f"decode kernel's shared memory")
    tiles = -(-kv_cap // tile)
    blocks = b * h * -(-ql // rows)
    want = -(-STREAM_WAVES * per_sm * sms // blocks)
    most = max(1, tiles * tile // STREAM_SPLIT_MIN_KEYS)
    split_keys = -(-tiles // max(1, min(want, most))) * tile
    return rows, tile, -(-kv_cap // split_keys), split_keys


def stream_decode_pad(k, v, d: int, dv: int) -> int:
    """Bytes the any-dtype decode adds to each stage buffer for a cache
    ``k``, ``v`` at head dims ``d``, ``dv``: 0 where every K and V row is
    whole 16-byte chunks on 16-byte boundaries (its tiles are bulk-copied
    as they are), else 16 (each tile's span is bulk-copied as the whole
    16-byte chunks around it)."""
    whole = ((d * k.dtype.itemsize) % 16 == 0
             and (dv * v.dtype.itemsize) % 16 == 0
             and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0)
    return 0 if whole else 16


def decode_route(q, k, v) -> str:
    """The route a CUDA decode call of these inputs takes: ``"tuned"``
    (the ring kernel; q in the cache's dtype or another), ``"wide"``,
    ``"f32"``, ``"mixed"`` (each only where d or dv, padded, is over
    TUNED_HEAD_DIM) or ``"stream"`` (the any-dtype kernel: the rest)."""
    d, dv = q.shape[3], v.shape[3]
    dp, dvp = padded_head_dims(d, dv)
    if tuned_kernel_takes("decode_attention", q, k, v, d, dv):
        return "tuned"
    if max(dp, dvp) > TUNED_HEAD_DIM:
        if wide_kernel_takes(q, k, v, dp, dvp):
            return "wide"
        if f32_kernel_takes(q, k, v, dp, dvp):
            return "f32"
        if mixed_kernel_takes(q, k, v, dp, dvp):
            return "mixed"
    return "stream"


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_flash(q, k, v) -> None:
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q, k and v on different devices: "
                         f"{sorted(map(str, devices))}")
    b, h, seq, d = q.shape
    if k.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} must be q's {tuple(q.shape)} "
                         f"and v {tuple(v.shape)} [{b},{h},{seq},dv]")
    _check_dtypes(q, k, v)
    if b < 1 or h < 1 or d < 1 or v.shape[3] < 1:
        raise ValueError(f"empty batch, heads or head dim: q "
                         f"{tuple(q.shape)}, v {tuple(v.shape)}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous")


def padded_head_dims(d: int, dv: int) -> tuple[int, int]:
    """The tuned flash kernel's and the wide kernels' head dims for true
    ``d`` and ``dv``: each rounded up to a multiple of HEAD_DIM_MULTIPLE."""
    step = HEAD_DIM_MULTIPLE
    return -(-d // step) * step, -(-dv // step) * step


def _check_aligned(*tensors) -> None:
    """TMA reads each tensor from a 16-byte boundary."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("q, k and v must start on 16-byte boundaries")


def _pad_last(t: torch.Tensor, size: int) -> torch.Tensor:
    """``t`` with its last dim zero-padded to ``size`` (itself if it fits)."""
    if t.shape[-1] == size:
        return t
    return torch.nn.functional.pad(t, (0, size - t.shape[-1])).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 256, block_k: int = 1024,
                    causal: bool = False) -> torch.Tensor:
    """[b, h, S, d] -> [b, h, S, dv] exact attention, optionally causal.

    q, k: [b, h, S, d]; v: [b, h, S, dv]; each f32, bf16 or f16, in any
    mix. Returns [b, h, S, dv] in q's dtype. ``block_q`` and ``block_k``
    are the JAX signature's block sizes: clamped to S, they must divide it,
    as there (else ValueError); the CUDA kernels walk the sequence in their
    own tiles.

    CUDA tensors go through a CUDA kernel on the tensors' device and
    current stream (``tuned_kernel_takes`` and ``wide_kernel_takes`` say
    which; the any-dtype kernel takes the rest), counted in
    ``flash_attention.launches``; CPU tensors go through
    ``reference_attention``."""
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
    with torch.cuda.device(q.device):
        return _launch_flash(q, k, v, causal,
                             torch.cuda.current_stream(q.device).cuda_stream)


def _launch_flash(q, k, v, causal: bool, stream: int) -> torch.Tensor:
    """One launch of the flash kernel that takes these checked inputs, on
    ``stream``; counted in ``flash_attention.launches``."""
    b, h, seq, d = q.shape
    dv = v.shape[3]
    dp, dvp = padded_head_dims(d, dv)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scale = 1.0 / math.sqrt(d)
    tuned = tuned_kernel_takes("flash_attention", q, k, v, dp, dvp)
    if tuned or wide_kernel_takes(q, k, v, dp, dvp):
        # Zero columns add nothing to q k^T, and the scale stays 1/sqrt(d).
        q, k, v = _pad_last(q, dp), _pad_last(k, dp), _pad_last(v, dvp)
        _check_aligned(q, k, v)
        out = torch.empty((b, h, seq, dvp), dtype=q.dtype, device=q.device)
        variant = _DTYPES[q.dtype] if tuned else f"wide_{_DTYPES[q.dtype]}"
        fn, err_str = _c_entry("flash_attention", variant,
                               [p, p, p, p, i, i, i, i, i, f, p])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b * h, seq, dp, dvp, int(causal), scale, stream)
    else:
        # The any-dtype kernel (every all-f32 call and every mix too):
        # padded dims, each operand in its own dtype (TMA reads each from a
        # 16-byte boundary: a view off one is copied).
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in
                   (_pad_last(q, dp), _pad_last(k, dp), _pad_last(v, dvp)))
        out = torch.empty((b, h, seq, dvp), dtype=q.dtype, device=q.device)
        cluster, groups, vp = cluster_flash_plan(dp, dvp)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, seq, dp, dvp, int(causal), scale)
        plan = (_CODES[k.dtype], _CODES[v.dtype], cluster, groups, vp)
        if q.dtype == torch.float32:
            fn, err_str = _c_entry("cluster_flash_q32", "run",
                                   [p, p, p, p, i, i, i, i, i, f, i, i, i, i,
                                    i, p])
            err = fn(*args, *plan, stream)
        else:
            fn, err_str = _c_entry("cluster_flash_q16", "run",
                                   [p, p, p, p, i, i, i, i, i, f, i, i, i, i,
                                    i, i, p])
            err = fn(*args, _CODES[q.dtype], *plan, stream)
    _raise_on(err, err_str, "flash_attention")
    with _LAUNCH_COUNT_MU:
        flash_attention.launches += 1
    return out if out.shape[3] == dv else out[..., :dv].contiguous()


flash_attention.launches = 0


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               kv_lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch decode attention with ragged KV lengths.

    q [b,h,ql,d] against padded caches k [b,h,cap,d] and v [b,h,cap,dv];
    keys at index >= kv_lengths[b] are masked. f32 einsum, mask, softmax,
    cast to q's dtype: the JAX package's ``xla_decode_attention``. The CPU path of
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
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be [b,h,ql,d], [b,h,cap,d] and "
                         f"[b,h,cap,dv], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    b, h, ql, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be [{b},{h},cap,{d}] and [{b},{h},cap,dv]")
    if kv_lengths.shape != (b,) or kv_lengths.dtype != torch.int32:
        raise ValueError(f"kv_lengths must be int32 [{b}], got "
                         f"{kv_lengths.dtype} {tuple(kv_lengths.shape)}")
    _check_dtypes(q, k, v)
    if ql < 1 or d < 1 or v.shape[3] < 1:
        raise ValueError(f"q_len {ql} and head dims d={d}, dv={v.shape[3]} "
                         f"must be at least 1")
    if b < 1 or h < 1 or k.shape[2] < 1:
        raise ValueError(f"empty batch, heads or cache: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if not all(t.is_contiguous() for t in (q, k, v, kv_lengths)):
        raise ValueError("q, k, v and kv_lengths must be contiguous")


def flash_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_lengths: torch.Tensor,
                           block_k: int = 512) -> torch.Tensor:
    """Decode-shaped attention: short q against a long padded KV cache.

    q:          [b, h, q_len, d]
    k:          [b, h, kv_cap, d]  — padded cache, valid prefix per batch
    v:          [b, h, kv_cap, dv]
    kv_lengths: [b] int32          — valid keys per sequence (> 0)

    q, k and v are each f32, bf16 or f16, in any mix. Returns
    [b, h, q_len, dv] in q's dtype. ``block_k`` is the JAX signature's
    block size: it must divide ``kv_cap`` once clamped to it, as there; the
    CUDA kernels walk the cache in their own tiles.

    CUDA tensors go through a CUDA kernel on the tensors' device and
    current stream (``decode_route`` says which): the tuned ring kernel
    one launch per group of up to MAX_Q_LEN query rows (the rows do not
    attend to each other), every other route one launch for every query
    row, each launch counted in ``flash_attention_decode.launches``. No route casts or copies
    the cache (the wide, f32 and mixed ones pad a head dim that is not a
    multiple of 16). CPU tensors go through ``decode_attention_reference``."""
    kv_cap = k.shape[2]
    block_k = min(block_k, kv_cap)
    if kv_cap % block_k:
        raise ValueError(f"block_k={block_k} must divide kv_cap {kv_cap}")
    _check(q, k, v, kv_lengths)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, kv_lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    with torch.cuda.device(q.device):
        return _launch_decode(q, k, v, kv_lengths,
                              torch.cuda.current_stream(q.device).cuda_stream)


def _launch_decode(q, k, v, kv_lengths, stream: int,
                   sms: int | None = None) -> torch.Tensor:
    """The decode kernel of ``decode_route`` for these checked inputs,
    launched on ``stream`` (the ring kernel once per group of query rows,
    the others once); each launch counted in
    ``flash_attention_decode.launches``.
    ``sms``: the SM count that sizes the splits of every kernel that splits
    the cache (the device's by default)."""
    b, h, ql, d = q.shape
    kv_cap, dv = k.shape[2], v.shape[3]
    p, i = ctypes.c_void_p, ctypes.c_int
    route = decode_route(q, k, v)
    sms = sms or _sm_count(q.device)
    if route == "wide":
        return _launch_decode_once(q, k, v, kv_lengths, stream,
                                   "decode_attention",
                                   f"wide_{_DTYPES[q.dtype]}",
                                   wide_decode_splits(b, h, ql, kv_cap, sms))
    if route in ("f32", "mixed"):
        split = f32_decode_splits(b, h, ql, kv_cap,
                                  padded_head_dims(d, dv)[1], sms)
        if route == "f32":
            return _launch_decode_once(q, k, v, kv_lengths, stream,
                                       "decode_attention", "f32tc", split)
        return _launch_decode_once(q, k, v, kv_lengths, stream,
                                   "mixed_decode", "f32tc", split,
                                   (_CODES[q.dtype], _CODES[k.dtype]))
    if route == "stream":
        return _launch_stream_decode(q, k, v, kv_lengths, stream, sms)
    ints = [i] * 8   # b, h, ql, row0, rows, cap, d, dv
    group = MAX_Q_LEN
    # The entry of K's and V's dtype; q's dtype goes as its code.
    fn, err_str = _c_entry("decode_attention", _DTYPES[k.dtype],
                           [p] * 7 + ints + [ctypes.c_float, i, i, i, p])
    splits, split_keys = tuned_decode_splits(
        b, h, kv_cap, tuned_decode_tile(k.dtype, d, dv), sms)
    work = ()
    if splits > 1:
        # f32 partials of one launch's rows; the launches of a call run in
        # stream order, each merged before the next writes.
        rows = min(ql, group)
        work = (torch.empty(b * h * splits * rows * dv,
                            dtype=torch.float32, device=q.device),
                torch.empty(b * h * splits * rows * 2,
                            dtype=torch.float32, device=q.device))
    ptrs = tuple(t.data_ptr() for t in work) or (None, None)
    tail = (splits, split_keys, _CODES[q.dtype])
    out = torch.empty((b, h, ql, dv), dtype=q.dtype, device=q.device)
    for row0 in range(0, ql, group):
        rows = min(group, ql - row0)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kv_lengths.data_ptr(), out.data_ptr(), *ptrs, b, h, ql,
                 row0, rows, kv_cap, d, dv, 1.0 / math.sqrt(d), *tail, stream)
        _raise_on(err, err_str, "decode_attention")
        with _LAUNCH_COUNT_MU:   # engines launch from several threads
            flash_attention_decode.launches += 1
    return out


def _launch_stream_decode(q, k, v, kv_lengths, stream: int,
                          sms: int) -> torch.Tensor:
    """One call of the any-dtype decode entry (the kernel and, with more
    than one split, its merge) for every query row, at the true head dims,
    each operand in its own dtype: the plan of ``stream_decode_plan``, f32
    partials in a workspace, out's rows rounded up to 4 columns."""
    b, h, ql, d = q.shape
    kv_cap, dv = k.shape[2], v.shape[3]
    rows, tile, splits, split_keys = stream_decode_plan(
        b, h, ql, kv_cap, d, dv, k.dtype.itemsize, v.dtype.itemsize, sms,
        stream_decode_pad(k, v, d, dv))
    dvo = -(-dv // 4) * 4
    work = (None, None)
    if splits > 1:
        work = tuple(torch.empty(b * h * splits * ql * n, dtype=torch.float32,
                                 device=q.device) for n in (dvo, 2))
    out = torch.empty((b, h, ql, dvo), dtype=q.dtype, device=q.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn, err_str = _c_entry("stream_decode", "run",
                           [p] * 7 + [i] * 11 + [ctypes.c_float] + [i] * 3
                           + [p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lengths.data_ptr(),
             out.data_ptr(), *(t if t is None else t.data_ptr() for t in work),
             b, h, ql, rows, kv_cap, d, dv, dvo, tile, splits, split_keys,
             1.0 / math.sqrt(d), _CODES[q.dtype], _CODES[k.dtype],
             _CODES[v.dtype], stream)
    _raise_on(err, err_str, "decode_attention")
    with _LAUNCH_COUNT_MU:
        flash_attention_decode.launches += 1
    return out if dvo == dv else out[..., :dv].contiguous()


def _launch_decode_once(q, k, v, kv_lengths, stream: int, source: str,
                        variant: str, split: tuple[int, int],
                        codes: tuple = ()) -> torch.Tensor:
    """One call of the wide, f32 or mixed decode entry
    ``<source>_<variant>`` (the kernel and its merge) for every query row,
    with head dims zero-padded and the cache split in (splits, keys per
    split); f32 partials in a workspace; ``codes``, q's and the cache's
    dtype codes, where the entry takes them."""
    b, h, ql, d = q.shape
    kv_cap, dv = k.shape[2], v.shape[3]
    dp, dvp = padded_head_dims(d, dv)
    q, k, v = _pad_last(q, dp), _pad_last(k, dp), _pad_last(v, dvp)
    _check_aligned(q, k, v)
    splits, split_keys = split
    part_o = torch.empty(b * h * splits * ql * dvp, dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty(b * h * splits * ql * 2, dtype=torch.float32,
                          device=q.device)
    out = torch.empty((b, h, ql, dvp), dtype=q.dtype, device=q.device)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn, err_str = _c_entry(source, variant,
                           [p] * 7 + [i] * 6 + [ctypes.c_float, i, i]
                           + [i] * len(codes) + [p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_lengths.data_ptr(),
             out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(), b, h, ql,
             kv_cap, dp, dvp, 1.0 / math.sqrt(d), splits, split_keys, *codes,
             stream)
    _raise_on(err, err_str, "decode_attention")
    with _LAUNCH_COUNT_MU:
        flash_attention_decode.launches += 1
    return out if dvp == dv else out[..., :dv].contiguous()


flash_attention_decode.launches = 0
