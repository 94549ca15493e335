"""The GPU port's decode attention held against the JAX package's.

On the CPU the port's ``flash_attention_decode`` runs its plain PyTorch
version (the CUDA kernel runs only on the card, where ``chip_smoke.py``
holds it against the same plain version). The same seeded numpy inputs go
through the JAX package's ``xla_decode_attention`` and its Pallas
``flash_attention_decode`` in interpret mode, at the JAX tests' shapes and
tolerances (f32 1e-4, bf16 3e-2, poisoned tail 1e-5), and at the inputs
the CUDA kernels took only later: head dims over 256 (257, DeepSeek-V3's
absorbed-MLA 576/512), f16, and q, k and v in different dtypes, each held
to the tolerance of its narrowest input (f32 1e-4, bf16 and f16 2e-2).
Also here: the wrapper's input checks, which kernel a CUDA call goes to
(the C entries mocked), and the kernel build's error paths, which run
without a card.
"""

import os
import stat
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.compute.flashattention import (
    flash_attention_decode as jax_flash_decode,
)
from k8s_dra_driver_tpu.compute.serving import xla_decode_attention
from k8s_dra_driver_tpu_torch.compute import _build, flashattention
from k8s_dra_driver_tpu_torch.compute.flashattention import (
    F32_BLOCKS_PER_SM,
    F32_DV_CHUNK,
    F32_KEYS,
    F32_ROWS,
    F32_SPLIT_MIN_KEYS,
    MAX_Q_LEN,
    STREAM_MAX_TILE,
    STREAM_ROWS,
    STREAM_SMEM_ONE,
    STREAM_SMEM_TWO,
    STREAM_SPLIT_MIN_KEYS,
    STREAM_WAVES,
    TUNED_BLOCKS_PER_SM,
    TUNED_HEAD_DIM,
    TUNED_SPLIT_MIN_KEYS,
    WIDE_BLOCKS_PER_SM,
    WIDE_KEYS,
    WIDE_SPLIT_MIN_KEYS,
    decode_attention_reference,
    f32_decode_splits,
    flash_attention_decode,
    stream_decode_pad,
    stream_decode_plan,
    stream_decode_smem,
    tuned_decode_splits,
    tuned_decode_tile,
    wide_decode_splits,
)

B, H, D, CAP = 4, 2, 8, 64
LENS = np.array([1, 17, 33, 64], np.int32)
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
# The tolerance of a call is that of its narrowest input: the JAX tests'
# 1e-4 where q, k and v are all f32, bf16's 2e-2 where any is 16-bit.
F32_TOL, HALF_TOL = 1e-4, 2e-2


def _tol(*dtypes) -> float:
    return F32_TOL if set(dtypes) == {"f32"} else HALF_TOL


def _agrees_with_jax(q, k, v, lens, dtypes, block_k=16):
    """The port's CPU path and the JAX kernel (interpret mode) on the same
    numpy inputs, cast to ``dtypes`` (q's, k's, v's): the port's output
    is in q's dtype and within the tolerance of the narrowest input."""
    tq, tk, tv = dtypes
    jax_out = jax_flash_decode(jnp.asarray(q, JNP[tq]), jnp.asarray(k, JNP[tk]),
                               jnp.asarray(v, JNP[tv]), lens, block_k=block_k,
                               interpret=True)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(TORCH[t])
            for a, t in ((q, tq), (k, tk), (v, tv))]
    out = flash_attention_decode(*args, torch.from_numpy(lens),
                                 block_k=block_k)
    assert out.dtype == TORCH[tq] and str(jax_out.dtype) == str(
        jnp.dtype(JNP[tq]))
    assert tuple(out.shape) == q.shape[:3] + (v.shape[3],)
    err = _max_abs(out.float().numpy(), jax_out.astype(jnp.float32))
    assert err < _tol(*dtypes), f"{dtypes}: {err}"
    return out


def _inputs(seed, ql, b=B, h=H, d=D, cap=CAP, dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, ql, d)).astype(np.float32)
    k = rng.standard_normal((b, h, cap, d)).astype(np.float32)
    v = rng.standard_normal((b, h, cap, d if dv is None else dv)).astype(
        np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


class TestAgainstJax:
    @pytest.mark.parametrize("ql", [1, 4])
    def test_f32_matches_xla_and_pallas(self, ql):
        q, k, v = _inputs(7, ql)
        xla = np.asarray(xla_decode_attention(q, k, v, LENS))
        pallas = np.asarray(jax_flash_decode(q, k, v, LENS, block_k=16,
                                             interpret=True))
        out = flash_attention_decode(*_t(q, k, v, LENS), block_k=16)
        assert out.dtype == torch.float32
        assert tuple(out.shape) == (B, H, ql, D)
        assert _max_abs(out.numpy(), xla) < 1e-4
        assert _max_abs(out.numpy(), pallas) < 1e-4

    @pytest.mark.parametrize("ql", [1, 4])
    def test_bf16_matches_xla_and_pallas(self, ql):
        q, k, v = _inputs(9, ql)
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        xla = np.asarray(xla_decode_attention(jq, jk, jv, LENS)
                         .astype(jnp.float32))
        pallas = np.asarray(jax_flash_decode(jq, jk, jv, LENS, block_k=16,
                                             interpret=True)
                            .astype(jnp.float32))
        tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
        out = flash_attention_decode(tq, tk, tv, torch.from_numpy(LENS),
                                     block_k=16)
        assert out.dtype == torch.bfloat16
        out = out.float().numpy()
        assert _max_abs(out, xla) < 3e-2
        assert _max_abs(out, pallas) < 3e-2

    def test_masked_tail_is_ignored(self):
        # Poison the padded tail: a masked key must not reach the output.
        b, h, d, cap = 2, 2, 8, 32
        q, k, v = _inputs(11, 1, b=b, h=h, d=d, cap=cap)
        lens = np.array([5, 9], np.int32)
        clean = flash_attention_decode(*_t(q, k, v, lens), block_k=8)
        for i, n in enumerate(lens):
            k[i, :, n:, :] = 1e6
            v[i, :, n:, :] = -1e6
        poisoned = flash_attention_decode(*_t(q, k, v, lens), block_k=8)
        assert _max_abs(poisoned.numpy(), clean.numpy()) < 1e-5
        jax_poisoned = np.asarray(jax_flash_decode(q, k, v, lens, block_k=8,
                                                   interpret=True))
        assert _max_abs(poisoned.numpy(), jax_poisoned) < 1e-4

    # Shapes the JAX function takes beyond the CUDA kernel's one launch: v's
    # head dim unlike k's, more than 8 query rows (the wrapper launches per
    # group of 8 on the card), and head dims over 256 (the general kernel).
    @pytest.mark.parametrize("ql,d,dv", [
        (1, 16, 32), (4, 32, 16), (16, D, D), (MAX_Q_LEN + 1, D, D),
        (20, 16, 24), (1, 2 * TUNED_HEAD_DIM, 2 * TUNED_HEAD_DIM)])
    def test_shapes_jax_takes(self, ql, d, dv):
        q, k, v = _inputs(17, ql, d=d, dv=dv)
        pallas = np.asarray(jax_flash_decode(q, k, v, LENS, block_k=16,
                                             interpret=True))
        out = flash_attention_decode(*_t(q, k, v, LENS), block_k=16)
        assert tuple(out.shape) == (B, H, ql, dv)
        assert _max_abs(out.numpy(), pallas) < 1e-4
        assert _max_abs(out.numpy(),
                        xla_decode_attention(q, k, v, LENS)) < 1e-4

    # Head dims over 256 at short caches, every dtype: 257 (past the tuned
    # kernel by one), DeepSeek-V3's absorbed-MLA decode (keys 512 + 64 = 576
    # wide, values 512; all query heads folded into one latent head's rows),
    # and a value dim over 256 beside a narrow key dim.
    @pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
    @pytest.mark.parametrize("ql,d,dv", [(1, 257, 257), (8, 576, 512),
                                         (MAX_Q_LEN + 2, 576, 512),
                                         (2, 64, 640)])
    def test_wide_head_dims_match_pallas(self, ql, d, dv, dtype):
        q, k, v = _inputs(23, ql, d=d, cap=32, dv=dv)
        lens = np.array([1, 7, 32, 20], np.int32)
        _agrees_with_jax(q, k, v, lens, (dtype,) * 3, block_k=16)

    # The tuned decode's ring kernel walks the cache in tiles of
    # tuned_decode_tile keys (128 at d = 64, 64 at 128, 32 at 256 in 16
    # bits): lengths 1, T - 1, T, T + 1 and the whole cache, in bf16 and
    # f16, held to JAX through the plain version.
    @pytest.mark.parametrize("dtype", ["bf16", "f16"])
    @pytest.mark.parametrize("ql,d,dv", [(1, 64, 64), (1, 128, 128),
                                         (2, 256, 256), (1, 128, 64)])
    def test_tile_edge_lengths_match_pallas(self, ql, d, dv, dtype):
        tile = tuned_decode_tile(TORCH[dtype], d, dv)
        cap = 2 * tile
        q, k, v = _inputs(37, ql, b=5, h=1, d=d, cap=cap, dv=dv)
        lens = np.array([1, tile - 1, tile, tile + 1, cap], np.int32)
        _agrees_with_jax(q, k, v, lens, (dtype,) * 3, block_k=16)

    # The one-dtype rows a per-warp kernel used to take on the card: f32 at
    # d or dv from 129 to 256 (the ring kernel's two-chunk form, 16-key
    # tiles: lengths 1, 15, 16, 17 and the cache) and rows that are not
    # whole 16-byte chunks (bf16 d = 66 on the any-dtype decode's element
    # reads), held to JAX's kernel in interpret mode through the plain
    # version.
    @pytest.mark.parametrize("dtype,ql,d,dv", [
        ("f32", 1, 256, 256), ("f32", 3, 256, 128), ("f32", 1, 128, 256),
        ("f32", 2, 192, 192), ("bf16", 1, 66, 66), ("bf16", 4, 66, 66)])
    def test_rows_the_per_warp_kernel_took_match_pallas(self, dtype, ql, d,
                                                        dv):
        q, k, v = _inputs(41, ql, b=5, h=2, d=d, cap=48, dv=dv)
        lens = np.array([1, 15, 16, 17, 48], np.int32)
        _agrees_with_jax(q, k, v, lens, (dtype,) * 3, block_k=16)

    # The f32 decode kernel's 64-key tiles and its splits at absorbed MLA's
    # layout (576/512, 128 query rows and 1): lengths 1, T - 1, T, T + 1, a
    # split's last key and the keys either side, and the whole cache, held
    # to JAX (interpret mode and XLA) through the plain version.
    @pytest.mark.parametrize("ql", [128, 1])
    def test_f32_tile_and_split_edge_lengths_match_pallas(self, ql):
        cap = 512
        split_keys = f32_decode_splits(8, 1, ql, cap, 512, 132)[1]
        assert split_keys < cap
        lens = np.array([1, F32_KEYS - 1, F32_KEYS, F32_KEYS + 1,
                         split_keys - 1, split_keys, split_keys + 1, cap],
                        np.int32)
        q, k, v = _inputs(41, ql, b=8, h=1, d=576, cap=cap, dv=512)
        out = _agrees_with_jax(q, k, v, lens, ("f32",) * 3, block_k=64)
        assert _max_abs(out.numpy(),
                        xla_decode_attention(q, k, v, lens)) < F32_TOL

    # The mixed tensor-core route's layout: DeepSeek-V3's absorbed MLA (128
    # query rows against one latent head of 576/512) with q's dtype apart
    # from the cache's, at a small cache, held to JAX (interpret mode)
    # through the plain version within the narrowest input's limit.
    @pytest.mark.parametrize("dtypes", [
        ("f32", "bf16", "bf16"), ("f32", "f16", "f16"),
        ("bf16", "f32", "f32"), ("bf16", "f16", "f16")])
    def test_mixed_dtypes_match_pallas_at_absorbed_mla(self, dtypes):
        cap = 64
        q, k, v = _inputs(43, 128, b=2, h=1, d=576, cap=cap, dv=512)
        lens = np.array([33, cap], np.int32)
        _agrees_with_jax(q, k, v, lens, dtypes, block_k=32)

    @pytest.mark.parametrize("ql", [1, 4])
    def test_f16_matches_xla_and_pallas(self, ql):
        q, k, v = _inputs(19, ql)
        out = _agrees_with_jax(q, k, v, LENS, ("f16",) * 3)
        jq, jk, jv = (jnp.asarray(a, jnp.float16) for a in (q, k, v))
        xla = xla_decode_attention(jq, jk, jv, LENS).astype(jnp.float32)
        assert _max_abs(out.float().numpy(), xla) < HALF_TOL

    # q, k and v in different dtypes, as JAX takes them: an f32 query over
    # a bf16 or f16 cache, a bf16 query over an f16 cache, K and V apart.
    @pytest.mark.parametrize("dtypes", [
        ("f32", "bf16", "bf16"), ("f32", "f16", "f16"),
        ("bf16", "f16", "f16"), ("f16", "bf16", "bf16"),
        ("f32", "f32", "bf16"), ("bf16", "bf16", "f32"),
        ("f16", "f32", "bf16")])
    @pytest.mark.parametrize("ql,d,dv", [(1, D, D), (4, 32, 16),
                                         (2, 320, 320)])
    def test_mixed_dtypes_match_pallas(self, ql, d, dv, dtypes):
        q, k, v = _inputs(29, ql, d=d, cap=32, dv=dv)
        lens = np.array([3, 32, 9, 16], np.int32)
        _agrees_with_jax(q, k, v, lens, dtypes)

    # The any-dtype decode kernel's calls at wide heads (1,024/1,024 and
    # 64/640) with K and V in different dtypes, held to JAX (interpret mode)
    # through the plain version within the narrowest input's limit.
    @pytest.mark.parametrize("dtypes", [
        ("f32", "f32", "bf16"), ("bf16", "bf16", "f32"),
        ("f16", "bf16", "f16")])
    @pytest.mark.parametrize("ql,d,dv", [(1, 1024, 1024),
                                         (MAX_Q_LEN + 2, 64, 640)])
    def test_k_and_v_apart_match_pallas_at_wide_heads(self, ql, d, dv,
                                                      dtypes):
        q, k, v = _inputs(47, ql, d=d, cap=32, dv=dv)
        lens = np.array([1, 31, 32, 9], np.int32)
        _agrees_with_jax(q, k, v, lens, dtypes, block_k=16)

    # The any-dtype decode kernel's tiles and splits at 1,024/1,024 in bf16
    # (stream_decode_plan: 8 keys a tile, 256 a split at 8 one-row caches of
    # 512): lengths 1, T - 1, T, T + 1, a split's last key and the keys
    # either side, and the whole cache, held to JAX through the plain
    # version.
    def test_stream_tile_and_split_edge_lengths_match_pallas(self):
        cap = 512
        _, tile, splits, split_keys = stream_decode_plan(
            8, 1, 1, cap, 1024, 1024, 2, 2, 132)
        assert (tile, splits, split_keys) == (8, 2, 256)
        lens = np.array([1, tile - 1, tile, tile + 1, split_keys - 1,
                         split_keys, split_keys + 1, cap], np.int32)
        q, k, v = _inputs(53, 1, b=8, h=1, d=1024, cap=cap, dv=1024)
        _agrees_with_jax(q, k, v, lens, ("bf16",) * 3, block_k=64)

    @pytest.mark.parametrize("block_k,raises", [(24, True), (48, True),
                                                (16, False), (512, False)])
    def test_block_k_must_divide_cap_as_in_jax(self, block_k, raises):
        # block_k is clamped to the cache first (512 -> 64 divides 64).
        q, k, v = _inputs(3, 1)
        if raises:
            with pytest.raises(ValueError):
                jax_flash_decode(q, k, v, LENS, block_k=block_k,
                                 interpret=True)
            with pytest.raises(ValueError, match="must divide kv_cap"):
                flash_attention_decode(*_t(q, k, v, LENS), block_k=block_k)
        else:
            jax_flash_decode(q, k, v, LENS, block_k=block_k, interpret=True)
            flash_attention_decode(*_t(q, k, v, LENS), block_k=block_k)


class TestWrapper:
    def test_cpu_tensors_take_the_plain_version_and_launch_nothing(self):
        q, k, v = _inputs(5, 2)
        args = _t(q, k, v, LENS)
        before = flash_attention_decode.launches
        out = flash_attention_decode(*args)
        assert flash_attention_decode.launches == before
        assert torch.equal(out, decode_attention_reference(*args))

    def test_plain_version_matches_xla(self):
        q, k, v = _inputs(13, 3)
        out = decode_attention_reference(*_t(q, k, v, LENS))
        assert _max_abs(out.numpy(),
                        xla_decode_attention(q, k, v, LENS)) < 1e-5

    @pytest.mark.parametrize("ql,d", [(MAX_Q_LEN + 1, D),
                                      (1, TUNED_HEAD_DIM + 1), (0, D)])
    def test_kernel_limits_raise(self, ql, d):
        # An empty q raises everywhere, as in JAX; more than 8 rows and a
        # head dim over 256 are JAX's results on the CPU path, and no head
        # dim is refused for the CUDA kernels any more.
        q, k, v = _inputs(1, ql, d=d, cap=16)
        args = _t(q, k, v, LENS)
        if ql < 1:
            with pytest.raises(ValueError, match="q_len"):
                flash_attention_decode(*args)
            return
        out = flash_attention_decode(*args)
        assert torch.equal(out, decode_attention_reference(*args))
        pallas = np.asarray(jax_flash_decode(q, k, v, LENS, block_k=16,
                                             interpret=True))
        assert _max_abs(out.numpy(), pallas) < F32_TOL
        assert not hasattr(flashattention, "check_kernel_head_dims")
        assert not hasattr(flashattention, "MAX_HEAD_DIM")

    def test_bad_inputs_raise(self):
        q, k, v = _inputs(2, 1)
        tq, tk, tv, tl = _t(q, k, v, LENS)
        cases = [
            (tq, tk, tv, tl.long()),                       # lengths dtype
            (tq, tk, tv, tl[:2]),                          # lengths shape
            (tq, tk, tv[:, :, :32], tl),                   # k/v mismatch
            (tq, tk.transpose(2, 3), tv, tl),              # k layout
            (tq.double(), tk.double(), tv.double(), tl),   # dtype
            (tq, tk.double(), tv, tl),                     # k's dtype
            (tq[0], tk, tv, tl),                           # q rank
        ]
        for case in cases:
            with pytest.raises(ValueError):
                flash_attention_decode(*case)

    def test_mixed_dtypes_take_the_plain_version(self):
        # On the CPU a mixed call is the plain version, in q's dtype.
        q, k, v = _inputs(6, 2)
        tq, tk, tv, tl = _t(q, k, v, LENS)
        args = (tq, tk.bfloat16(), tv.half(), tl)
        out = flash_attention_decode(*args)
        assert out.dtype == torch.float32
        assert torch.equal(out, decode_attention_reference(*args))

    def test_non_contiguous_raises(self):
        q, k, v = _inputs(4, 1)
        tq, tk, tv, tl = _t(q, k, v, LENS)
        strided = torch.empty(B, H, CAP, 2 * D)[..., ::2]
        strided.copy_(tk)
        assert not strided.is_contiguous()
        with pytest.raises(ValueError, match="contiguous"):
            flash_attention_decode(tq, strided, tv, tl)


class _FakeEntry:
    """A C entry that records its arguments and returns cudaSuccess."""

    def __init__(self):
        self.argtypes = None
        self.restype = None
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _FakeLib:
    def __init__(self):
        self.entries = {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, _FakeEntry())


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    return lib


class TestRouting:
    """Which C entry a CUDA call reaches, with what: the launch routine
    that ``flash_attention_decode`` runs on CUDA tensors, given CPU tensors
    and a mocked library (no card here)."""

    def _launch(self, ql, d, dv, dtypes, b=2, h=3, cap=16):
        q, k, v = _inputs(31, ql, b=b, h=h, d=d, cap=cap, dv=dv)
        args = [torch.from_numpy(a).to(TORCH[t])
                for a, t in ((q, dtypes[0]), (k, dtypes[1]), (v, dtypes[2]))]
        lens = torch.full((b,), cap, dtype=torch.int32)
        before = flash_attention_decode.launches
        out = flashattention._launch_decode(*args, lens, stream=0, sms=132)
        assert out.shape == (b, h, ql, dv) and out.dtype == TORCH[dtypes[0]]
        return flash_attention_decode.launches - before

    def test_1024_wide_call_goes_to_the_general_entry(self, fake_lib):
        # Past the wide route's 576/512: the any-dtype decode entry, every
        # query row in one launch (the SIMT kernel it replaced took one per
        # 8 rows).
        launches = self._launch(MAX_Q_LEN + 2, 1024, 1024, ("bf16",) * 3)
        assert launches == 1 and set(fake_lib.entries) == {
            "stream_decode_run", "stream_decode_error_string"}
        (call,) = fake_lib.entries["stream_decode_run"].calls
        rows, tile, splits, split_keys = stream_decode_plan(
            2, 3, 10, 16, 1024, 1024, 2, 2, 132)
        assert rows == STREAM_ROWS and splits == 1
        # one split: no workspace; b, h, ql, rows a block, cap, d, dv, out's
        # row, tile, splits, keys a split, scale, q/k/v codes, stream
        assert call[5:7] == (None, None)
        assert call[7:] == (2, 3, 10, rows, 16, 1024, 1024, 1024, tile, 1,
                            split_keys, pytest.approx(1 / 32), 1, 1, 1, 0)

    @pytest.mark.parametrize("ql,d,dv,dtypes,entry,codes", [
        # the tuned entries' splits, keys a split and q's dtype code: the
        # ring kernel's one split of whole 64-key tiles; f32 at 256/64 (two
        # chunks a lane) one split of one 16-key tile, the cache
        (1, 128, 128, ("f16",) * 3, "decode_attention_f16", (1, 64, 2)),
        (4, 256, 64, ("f32",) * 3, "decode_attention_f32", (1, 16, 0)),
        # bf16 at d = 257 takes the wide kernels, padded to 272
        (1, 257, 64, ("bf16",) * 3, "decode_attention_wide_bf16", (1, 32)),
        # q in its own dtype: the ring kernel of the cache's dtype (both the
        # SIMT general entry's before the ring took them)
        (1, 128, 128, ("f32", "bf16", "bf16"), "decode_attention_bf16",
         (1, 64, 0)),
        (2, 64, 64, ("bf16", "f16", "f16"), "decode_attention_f16",
         (1, 128, 1))])
    def test_tuned_and_general_entries(self, fake_lib, ql, d, dv, dtypes,
                                       entry, codes):
        assert self._launch(ql, d, dv, dtypes) == 1
        (call,) = fake_lib.entries[entry].calls
        if "wide" in entry:
            # b, h, ql, cap, padded d and dv, scale, splits, split keys
            assert call[7:-1] == (2, 3, ql, 16, -(-d // 16) * 16, dv,
                                  pytest.approx(d ** -0.5)) + codes
            return
        # row0, rows, cap, d, dv, scale; then the tuned entry's splits
        # (after its two workspace pointers)
        assert call[10:16] == (0, ql, 16, d, dv, pytest.approx(d ** -0.5))
        assert call[16:-1] == codes

    @pytest.mark.parametrize("dtype", ["bf16", "f16"])
    @pytest.mark.parametrize("d,dv,padded", [
        (257, 257, (272, 272)), (320, 320, (320, 320)),
        (576, 512, (576, 512)), (64, 320, (64, 320))])
    def test_wide_head_dims_reach_the_wide_entry(self, fake_lib, dtype, d,
                                                 dv, padded):
        # Every query row in one call (10 rows: the tuned kernels would
        # take two launches), dims padded to 16, the scale
        # of the true d.
        assert self._launch(MAX_Q_LEN + 2, d, dv, (dtype,) * 3) == 1
        assert set(fake_lib.entries) == {f"decode_attention_wide_{dtype}",
                                         "decode_attention_error_string"}
        (call,) = fake_lib.entries[f"decode_attention_wide_{dtype}"].calls
        splits, split_keys = wide_decode_splits(2, 3, 10, 16, 132)
        assert call[7:-1] == (2, 3, 10, 16, *padded,
                              pytest.approx(d ** -0.5), splits, split_keys)

    def test_absorbed_mla_decode_is_one_launch(self, fake_lib):
        # DeepSeek-V3's absorbed layout: 128 query rows against one latent
        # head of 576/512, as one launch with the cache split across blocks.
        b, cap = 4, 4096
        q = torch.zeros((b, 1, 128, 576), dtype=torch.bfloat16)
        k = torch.zeros((b, 1, cap, 576), dtype=torch.bfloat16)
        v = torch.zeros((b, 1, cap, 512), dtype=torch.bfloat16)
        lens = torch.tensor([1, 31, 33, cap], dtype=torch.int32)
        before = flash_attention_decode.launches
        out = flashattention._launch_decode(q, k, v, lens, stream=7, sms=132)
        assert flash_attention_decode.launches == before + 1
        assert out.shape == (b, 1, 128, 512) and out.dtype == torch.bfloat16
        (call,) = fake_lib.entries["decode_attention_wide_bf16"].calls
        splits, split_keys = wide_decode_splits(b, 1, 128, cap, 132)
        assert splits > 1 and (splits - 1) * split_keys < cap
        assert call[:5] == tuple(t.data_ptr() for t in (q, k, v, lens, out))
        assert call[7:] == (b, 1, 128, cap, 576, 512,
                            pytest.approx(576 ** -0.5), splits, split_keys,
                            7)

    @pytest.mark.parametrize("ql,d,dv,dtypes", [
        (4, 576, 512, ("f32", "bf16", "bf16")),
        (4, 576, 512, ("bf16", "f16", "f16")),
        (1, 1024, 1024, ("bf16",) * 3),
        (1, 64, 640, ("f16",) * 3)])
    def test_what_the_wide_kernels_do_not_take_stays_general(
            self, fake_lib, ql, d, dv, dtypes):
        # Padded dims past 576/512 take the any-dtype decode entry, at the
        # true dims (f32 at 576/512 takes the f32 kernels:
        # test_f32_wide_head_dims_reach_the_f32_entry); mixed dtypes at
        # 576/512, the SIMT general entry's before the mixed route, take the
        # mixed entry. Each one launch a call.
        mixed = dtypes[0] != dtypes[1]
        entry = "mixed_decode_f32tc" if mixed else "stream_decode_run"
        assert self._launch(ql, d, dv, dtypes) == 1
        assert set(fake_lib.entries) == {
            entry, entry.replace("f32tc", "error_string").replace(
                "run", "error_string")}
        if not mixed:
            (call,) = fake_lib.entries[entry].calls
            assert call[12:14] == (d, dv) and call[-4:-1] == tuple(
                {"f32": 0, "bf16": 1, "f16": 2}[t] for t in dtypes)

    # All-f32 decode with d or dv over 256, up to padded 576/512, takes the
    # f32 tensor-core kernels (3xTF32): every query row in one call, dims
    # padded to 16, the scale of the true d, the split count and keys a
    # split of f32_decode_splits, and an f32 workspace (two pointers).
    # 576/512 at one row was the general entry's before the f32 route.
    @pytest.mark.parametrize("ql,d,dv,padded", [
        (128, 576, 512, (576, 512)), (1, 576, 512, (576, 512)),
        (MAX_Q_LEN + 2, 257, 257, (272, 272)), (1, 64, 320, (64, 320)),
        (3, 300, 8, (304, 16))])
    def test_f32_wide_head_dims_reach_the_f32_entry(self, fake_lib, ql, d,
                                                    dv, padded):
        assert self._launch(ql, d, dv, ("f32",) * 3, cap=200) == 1
        assert set(fake_lib.entries) == {"decode_attention_f32tc",
                                         "decode_attention_error_string"}
        (call,) = fake_lib.entries["decode_attention_f32tc"].calls
        splits, split_keys = f32_decode_splits(2, 3, ql, 200, padded[1], 132)
        assert split_keys % F32_KEYS == 0
        assert call[7:-1] == (2, 3, ql, 200, *padded,
                              pytest.approx(d ** -0.5), splits, split_keys)
        assert all(call[5:7]) and call[5] != call[6]

    def test_f32_absorbed_mla_decode_is_one_launch(self, fake_lib):
        # DeepSeek-V3's absorbed layout in f32: 128 query rows against one
        # latent head of 576/512, one call with the cache split.
        b, cap = 4, 4096
        q = torch.zeros((b, 1, 128, 576))
        k = torch.zeros((b, 1, cap, 576))
        v = torch.zeros((b, 1, cap, 512))
        lens = torch.tensor([1, 63, 65, cap], dtype=torch.int32)
        before = flash_attention_decode.launches
        out = flashattention._launch_decode(q, k, v, lens, stream=7, sms=132)
        assert flash_attention_decode.launches == before + 1
        assert out.shape == (b, 1, 128, 512) and out.dtype == torch.float32
        (call,) = fake_lib.entries["decode_attention_f32tc"].calls
        splits, split_keys = f32_decode_splits(b, 1, 128, cap, 512, 132)
        assert splits > 1 and (splits - 1) * split_keys < cap
        assert call[:5] == tuple(t.data_ptr() for t in (q, k, v, lens, out))
        assert call[7:] == (b, 1, 128, cap, 576, 512,
                            pytest.approx(576 ** -0.5), splits, split_keys,
                            7)

    @pytest.mark.parametrize("ql,d,dv,entry", [
        (1, 128, 128, "decode_attention_f32"),
        (MAX_Q_LEN + 2, 256, 256, "decode_attention_f32"),
        (1, 1024, 1024, "stream_decode_run"),
        (2, 64, 640, "stream_decode_run"),
        (1, 592, 64, "stream_decode_run")])
    def test_f32_the_f32_kernels_do_not_take(self, fake_lib, ql, d, dv,
                                             entry):
        # f32 up to 256 stays on the tuned kernels (the serve shape's ring
        # kernel), one launch per 8 query rows; f32 past padded 576/512 on
        # the any-dtype decode kernel, one launch a call.
        tuned = entry.startswith("decode_attention")
        assert self._launch(ql, d, dv, ("f32",) * 3) == (
            -(-ql // MAX_Q_LEN) if tuned else 1)
        assert set(fake_lib.entries) == {
            entry, "decode_attention_error_string" if tuned
            else "stream_decode_error_string"}

    @pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
    def test_tuned_entry_takes_splits_and_a_workspace(self, fake_lib, dtype):
        # 2 x 2 caches of 4096 keys leave most SMs idle: the ring kernel's
        # cache is split, with an f32 workspace of [b h, splits, rows, dv]
        # and [b h, splits, rows, 2]; ql 10 is two launches on one
        # workspace (8 rows, then 2).
        b, h, ql, d, cap = 2, 2, MAX_Q_LEN + 2, 64, 4096
        args = [torch.zeros(shape, dtype=TORCH[dtype]) for shape in (
            (b, h, ql, d), (b, h, cap, d), (b, h, cap, d))]
        lens = torch.full((b,), cap, dtype=torch.int32)
        before = flash_attention_decode.launches
        flashattention._launch_decode(*args, lens, stream=5, sms=132)
        assert flash_attention_decode.launches == before + 2
        calls = fake_lib.entries[f"decode_attention_{dtype}"].calls
        tile = tuned_decode_tile(TORCH[dtype], d, d)
        splits, split_keys = tuned_decode_splits(b, h, cap, tile, 132)
        assert tile and splits > 1 and split_keys % tile == 0
        code = {"f32": 0, "bf16": 1, "f16": 2}[dtype]
        assert [c[7:] for c in calls] == [
            (b, h, ql, row0, rows, cap, d, d, pytest.approx(d ** -0.5),
             splits, split_keys, code, 5) for row0, rows in ((0, 8), (8, 2))]
        # One workspace, both pointers set, the same in both launches.
        assert calls[0][5:7] == calls[1][5:7] and all(calls[0][5:7])
        assert calls[0][5] != calls[0][6]

    # Routing of the one-dtype rows a per-warp kernel used to take: f32 at
    # 256/256 (64 chunks) on the ring kernel, two chunks a lane, in 16-key
    # tiles, with the one cache of 4096 keys split; rows that are not whole
    # 16-byte chunks (bf16 d = 66: 132 bytes; f16 dv = 60: 120 bytes) on the
    # any-dtype decode entry, every query row in one launch, at the true
    # dims, with a stage 16 bytes longer a buffer (its tiles are copied as
    # the 16-byte chunks around them).
    @pytest.mark.parametrize("dtype,d,dv,entry", [
        ("bf16", 66, 66, "stream_decode_run"),
        ("f16", 128, 60, "stream_decode_run"),
        ("f32", 256, 256, "decode_attention_f32")])
    def test_rows_the_ring_does_not_take_keep_one_split(self, fake_lib,
                                                        dtype, d, dv, entry):
        code = {"f32": 0, "bf16": 1, "f16": 2}[dtype]
        ql = 1 if entry.startswith("decode") else MAX_Q_LEN + 2
        assert self._launch(ql, d, dv, (dtype,) * 3, b=1, h=1,
                            cap=4096) == 1
        assert set(fake_lib.entries) == {
            entry, entry.replace("run", "error_string").replace(
                "f32", "error_string")}
        (call,) = fake_lib.entries[entry].calls
        if entry == "decode_attention_f32":
            tile = tuned_decode_tile(TORCH[dtype], d, dv)
            splits, split_keys = tuned_decode_splits(1, 1, 4096, tile, 132)
            assert tile == 16 and splits > 1 and split_keys % tile == 0
            assert all(call[5:7]) and call[-4:-1] == (splits, split_keys,
                                                      code)
            return
        assert tuned_decode_tile(TORCH[dtype], d, dv) == 0
        size = TORCH[dtype].itemsize
        rows, tile, splits, split_keys = stream_decode_plan(
            1, 1, ql, 4096, d, dv, size, size, 132, 16)
        assert call[7:-1] == (1, 1, ql, rows, 4096, d, dv, -(-dv // 4) * 4,
                              tile, splits, split_keys,
                              pytest.approx(d ** -0.5), code, code, code)

    @pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
    def test_k_off_a_16_byte_boundary_keeps_one_split(self, fake_lib, dtype):
        # The ring kernel's bulk copies need 16-byte aligned rows: a cache
        # view one element off a boundary, in one dtype, goes to the
        # any-dtype decode entry with the caller's pointer, one launch for
        # every query row, the plan's stages 16 bytes longer a buffer.
        b, h, d, cap = 1, 1, 128, 4096
        t = TORCH[dtype]
        flat = torch.zeros(b * h * cap * d + 1, dtype=t)
        k = flat[1:].view(b, h, cap, d)
        assert k.is_contiguous() and k.data_ptr() % 16
        q = torch.zeros((b, h, MAX_Q_LEN + 2, d), dtype=t)
        v = torch.zeros((b, h, cap, d), dtype=t)
        lens = torch.full((b,), cap, dtype=torch.int32)
        assert flashattention.decode_route(q, k, v) == "stream"
        before = flash_attention_decode.launches
        flashattention._launch_decode(q, k, v, lens, stream=0, sms=132)
        assert flash_attention_decode.launches == before + 1
        assert set(fake_lib.entries) == {"stream_decode_run",
                                         "stream_decode_error_string"}
        (call,) = fake_lib.entries["stream_decode_run"].calls
        assert call[1] == k.data_ptr()
        assert stream_decode_pad(k, v, d, d) == 16
        assert stream_decode_pad(v, v, d, d) == 0
        rows, tile, splits, split_keys = stream_decode_plan(
            b, h, MAX_Q_LEN + 2, cap, d, d, t.itemsize, t.itemsize, 132, 16)
        # rows a block, cap, d, dv, out's row, tile, splits, keys a split
        assert call[10:-5] == (rows, cap, d, d, d, tile, splits, split_keys)

    def test_query_rows_a_launch_shrink_only_past_the_shared_memory(
            self, fake_lib):
        # At d = 7,000 in bf16 seven rows' q and O do not fit a block's
        # shared memory beside one key a stage; a block takes 4 rows, still
        # one launch for the 7 rows (a grid dimension of 2 groups).
        d = 7000
        assert stream_decode_smem(1, 7, d, 8, 2, 2) > STREAM_SMEM_ONE
        assert self._launch(7, d, 8, ("f32", "bf16", "bf16"), b=1, h=1,
                            cap=2) == 1
        (call,) = fake_lib.entries["stream_decode_run"].calls
        rows, tile = call[10], call[15]
        assert (rows, tile) == stream_decode_plan(1, 1, 7, 2, d, 8, 2, 2,
                                                  132)[:2]
        assert rows == 4 and stream_decode_smem(
            tile, rows, d, 8, 2, 2) <= STREAM_SMEM_ONE


class TestMixedRouting:
    """Where a CUDA call whose q's dtype differs from the one K and V
    share goes (the C entries mocked, as in TestRouting): the ring kernel of
    the cache's dtype at d, dv <= 256 on rows of whole 16-byte chunks, the
    mixed tensor-core entry past 256 up to padded 576/512, the any-dtype
    decode entry for the rest and for K and V apart."""

    _launch = TestRouting._launch

    # Each class of the mixed route at the serve shape's head dim: the ring
    # kernel built for the cache, with q's dtype code after the splits.
    @pytest.mark.parametrize("dtypes,code", [
        (("bf16", "f32", "f32"), 1), (("f16", "f32", "f32"), 2),
        (("f32", "bf16", "bf16"), 0), (("f32", "f16", "f16"), 0),
        (("bf16", "f16", "f16"), 1), (("f16", "bf16", "bf16"), 2)])
    @pytest.mark.parametrize("ql", [1, MAX_Q_LEN + 2])
    def test_a_q_of_another_dtype_reaches_the_ring_kernel(
            self, fake_lib, dtypes, code, ql):
        d = 128
        assert self._launch(ql, d, d, dtypes, cap=4096) == -(-ql // MAX_Q_LEN)
        entry = f"decode_attention_{dtypes[1]}"
        assert set(fake_lib.entries) == {entry,
                                         "decode_attention_error_string"}
        tile = tuned_decode_tile(TORCH[dtypes[1]], d, d)
        splits, split_keys = tuned_decode_splits(2, 3, 4096, tile, 132)
        assert tile > 0 and splits > 1
        for call in fake_lib.entries[entry].calls:
            assert call[-4:-1] == (splits, split_keys, code)
            assert all(call[5:7])   # the split cache's workspace

    # Past 256 (absorbed MLA's 576/512 among them), every query row in one
    # call of the mixed entry: padded dims, the true d's scale, the f32
    # route's split count, then q's and the cache's dtype codes.
    @pytest.mark.parametrize("dtypes,codes", [
        (("f32", "bf16", "bf16"), (0, 1)), (("f32", "f16", "f16"), (0, 2)),
        (("bf16", "f32", "f32"), (1, 0)), (("f16", "bf16", "bf16"), (2, 1))])
    @pytest.mark.parametrize("ql,d,dv,padded", [
        (128, 576, 512, (576, 512)), (1, 576, 512, (576, 512)),
        (MAX_Q_LEN + 2, 257, 64, (272, 64)), (3, 64, 300, (64, 304))])
    def test_wide_heads_reach_the_mixed_entry(self, fake_lib, dtypes, codes,
                                              ql, d, dv, padded):
        assert self._launch(ql, d, dv, dtypes, cap=200) == 1
        assert set(fake_lib.entries) == {"mixed_decode_f32tc",
                                         "mixed_decode_error_string"}
        (call,) = fake_lib.entries["mixed_decode_f32tc"].calls
        splits, split_keys = f32_decode_splits(2, 3, ql, 200, padded[1], 132)
        assert call[7:-1] == (2, 3, ql, 200, *padded,
                              pytest.approx(d ** -0.5), splits, split_keys,
                              *codes)
        assert all(call[5:7]) and call[5] != call[6]

    # What the any-dtype decode kernel takes (the SIMT general kernel's
    # before it): K and V in different dtypes, a mixed call whose cache rows
    # the ring does not take (d = 66 in bf16, dv = 60 in f16, f32 at 256: 64
    # chunks), and head dims past 576/512; at the true dims, each operand's
    # code, the splits of stream_decode_plan and, with more than one, a
    # workspace.
    @pytest.mark.parametrize("ql,d,dv,dtypes", [
        (1, 128, 128, ("f32", "f32", "bf16")),
        (1, 576, 512, ("bf16", "bf16", "f32")),
        (2, 66, 66, ("f32", "bf16", "bf16")),
        (1, 128, 60, ("bf16", "f16", "f16")),
        (1, 255, 255, ("bf16", "f32", "f32")),
        (1, 1024, 1024, ("f32", "bf16", "bf16")),
        (1, 64, 640, ("bf16", "f32", "f32"))])
    def test_what_the_mixed_routes_do_not_take_stays_general(
            self, fake_lib, ql, d, dv, dtypes):
        assert self._launch(ql, d, dv, dtypes, cap=1024) == 1
        assert set(fake_lib.entries) == {"stream_decode_run",
                                         "stream_decode_error_string"}
        (call,) = fake_lib.entries["stream_decode_run"].calls
        sizes = [TORCH[t].itemsize for t in dtypes[1:]]
        rows, tile, splits, split_keys = stream_decode_plan(
            2, 3, ql, 1024, d, dv, *sizes, 132)
        assert call[7:-1] == (2, 3, ql, rows, 1024, d, dv, -(-dv // 4) * 4,
                              tile, splits, split_keys,
                              pytest.approx(d ** -0.5)) + tuple(
            {"f32": 0, "bf16": 1, "f16": 2}[t] for t in dtypes)
        # 6 caches of 1024 keys leave SMs idle: split, with a workspace.
        assert splits > 1 and all(call[5:7]) and call[5] != call[6]

    def test_a_cache_off_a_16_byte_boundary_stays_general(self, fake_lib):
        # A mixed call whose cache view starts mid-chunk: the any-dtype
        # decode entry, given the caller's view (the kernel copies it with
        # plain loads).
        b, h, d, cap = 1, 1, 128, 64
        flat = torch.zeros(b * h * cap * d + 1, dtype=torch.bfloat16)
        k = flat[1:].view(b, h, cap, d)
        q = torch.zeros((b, h, 1, d))
        v = torch.zeros((b, h, cap, d), dtype=torch.bfloat16)
        lens = torch.full((b,), cap, dtype=torch.int32)
        flashattention._launch_decode(q, k, v, lens, stream=0, sms=132)
        assert set(fake_lib.entries) == {"stream_decode_run",
                                         "stream_decode_error_string"}
        (call,) = fake_lib.entries["stream_decode_run"].calls
        assert call[1] == k.data_ptr() and call[1] % 16

    # No route casts or copies the cache: the entry gets the caller's K and
    # V (and q) by pointer, in their own dtypes.
    @pytest.mark.parametrize("ql,d,dv,entry", [
        (1, 128, 128, "decode_attention_bf16"),
        (128, 576, 512, "mixed_decode_f32tc")])
    def test_the_entry_gets_the_callers_k_and_v(self, fake_lib, ql, d, dv,
                                                entry):
        b, cap = 2, 256
        q = torch.zeros((b, 1, ql, d))
        k = torch.zeros((b, 1, cap, d), dtype=torch.bfloat16)
        v = torch.zeros((b, 1, cap, dv), dtype=torch.bfloat16)
        lens = torch.tensor([1, cap], dtype=torch.int32)
        out = flashattention._launch_decode(q, k, v, lens, stream=0, sms=132)
        (call,) = fake_lib.entries[entry].calls
        assert call[:5] == tuple(t.data_ptr() for t in (q, k, v, lens, out))
        assert k.dtype == v.dtype == torch.bfloat16
        assert out.dtype == torch.float32


class TestWideSplits:
    """``wide_decode_splits``: the cache split of the wide decode kernel,
    from the shapes and the SM count alone."""

    @pytest.mark.parametrize("b,h,ql,cap,sms", [
        (32, 1, 128, 4096, 132), (1, 1, 1, 16, 132), (3, 2, 70, 300, 132),
        (64, 8, 1, 4096, 132), (1, 1, 1, 1 << 20, 132), (2, 2, 64, 33, 8)])
    def test_splits_cover_the_cache_in_whole_tiles(self, b, h, ql, cap, sms):
        splits, split_keys = wide_decode_splits(b, h, ql, cap, sms)
        assert splits >= 1 and split_keys % WIDE_KEYS == 0
        # Every key in one split, no split empty by construction.
        assert (splits - 1) * split_keys < cap <= splits * split_keys

    def test_one_split_when_the_row_tiles_fill_the_sms(self):
        # 64 x 8 heads x 1 row tile = 512 blocks >= 2 a SM on 132 SMs.
        assert wide_decode_splits(64, 8, 1, 4096, 132) == (1, 4096)

    def test_a_cache_shorter_than_a_tile_is_one_tile(self):
        assert wide_decode_splits(1, 1, 1, 16, 132) == (1, WIDE_KEYS)
        assert wide_decode_splits(1, 1, 1, WIDE_KEYS + 1, 132) == (
            1, 2 * WIDE_KEYS)

    def test_splits_fill_the_sms_but_keep_their_least_keys(self):
        # Absorbed MLA at 32 sequences: 64 row tiles, about 2 blocks an SM.
        splits, split_keys = wide_decode_splits(32, 1, 128, 4096, 132)
        assert splits * 64 >= WIDE_BLOCKS_PER_SM * 132
        assert (splits - 1) * 64 < WIDE_BLOCKS_PER_SM * 132
        # One sequence, one row: the split count stops at the least keys.
        splits, split_keys = wide_decode_splits(1, 1, 1, 4096, 132)
        assert split_keys == WIDE_SPLIT_MIN_KEYS
        assert splits == 4096 // WIDE_SPLIT_MIN_KEYS


class TestF32Splits:
    """``f32_decode_splits``: the cache split of the f32 decode kernel, from
    the shapes and the SM count alone."""

    @pytest.mark.parametrize("b,h,ql,cap,dv,sms", [
        (32, 1, 128, 4096, 512, 132), (1, 1, 1, 16, 272, 132),
        (3, 2, 70, 300, 320, 132), (64, 8, 1, 4096, 512, 132),
        (1, 1, 1, 1 << 20, 512, 132), (2, 2, 64, 65, 512, 8)])
    def test_splits_cover_the_cache_in_whole_tiles(self, b, h, ql, cap, dv,
                                                   sms):
        splits, split_keys = f32_decode_splits(b, h, ql, cap, dv, sms)
        assert splits >= 1 and split_keys % F32_KEYS == 0
        # Every key in one split, no split empty by construction.
        assert (splits - 1) * split_keys < cap <= splits * split_keys

    def test_the_count_comes_from_the_shapes_and_the_sm_count(self):
        # Absorbed MLA at 32 sequences: 32 x 2 row tiles x 2 dv chunks =
        # 128 blocks a split, about F32_BLOCKS_PER_SM blocks an SM.
        blocks = 32 * -(-128 // F32_ROWS) * -(-512 // F32_DV_CHUNK)
        for sms in (66, 132, 264):
            splits, _ = f32_decode_splits(32, 1, 128, 4096, 512, sms)
            assert splits * blocks >= F32_BLOCKS_PER_SM * sms
            assert (splits - 1) * blocks < F32_BLOCKS_PER_SM * sms
        # A dv within one chunk halves the blocks a split: twice the splits.
        assert (f32_decode_splits(32, 1, 128, 4096, 256, 132)[0]
                >= f32_decode_splits(32, 1, 128, 4096, 512, 132)[0])

    def test_one_split_when_the_row_tiles_fill_the_sms(self):
        # 64 x 8 heads x 1 row tile x 2 chunks = 1,024 blocks.
        assert f32_decode_splits(64, 8, 1, 4096, 512, 132) == (1, 4096)

    def test_a_cache_shorter_than_a_tile_is_one_tile(self):
        assert f32_decode_splits(1, 1, 1, 16, 512, 132) == (1, F32_KEYS)
        assert f32_decode_splits(1, 1, 1, F32_KEYS + 1, 512, 132) == (
            1, 2 * F32_KEYS)

    def test_splits_keep_their_least_keys(self):
        # One sequence, one row: the split count stops at the least keys.
        splits, split_keys = f32_decode_splits(1, 1, 1, 4096, 512, 132)
        assert split_keys == F32_SPLIT_MIN_KEYS
        assert splits == 4096 // F32_SPLIT_MIN_KEYS


class TestStreamPlan:
    """``stream_decode_plan``: the rows a block, the tile and the cache split
    of the any-dtype decode kernel, from the shapes and the SM count alone."""

    @pytest.mark.parametrize("b,h,ql,cap,d,dv,ks,vs", [
        (32, 4, 1, 4096, 1024, 1024, 2, 2), (32, 8, 1, 4096, 64, 640, 2, 2),
        (32, 4, 1, 4096, 1024, 1024, 4, 4), (3, 2, 10, 300, 66, 130, 2, 4),
        (1, 1, 1, 16, 2048, 2048, 4, 2), (1, 1, 1, 1 << 20, 128, 128, 4, 2),
        (2, 2, 64, 33, 576, 512, 2, 4)])
    def test_splits_cover_the_cache_in_whole_tiles(self, b, h, ql, cap, d,
                                                   dv, ks, vs):
        rows, tile, splits, split_keys = stream_decode_plan(
            b, h, ql, cap, d, dv, ks, vs, 132)
        assert 1 <= rows <= min(ql, STREAM_ROWS)
        assert 1 <= tile <= STREAM_MAX_TILE and (tile < 8 or tile % 8 == 0)
        assert split_keys % tile == 0
        # Every key in one split, no split empty by construction.
        assert (splits - 1) * split_keys < cap <= splits * split_keys
        assert stream_decode_smem(tile, rows, d, dv, ks,
                                  vs) <= STREAM_SMEM_ONE

    def test_two_blocks_an_sm_where_a_tile_of_8_fits(self):
        # bf16 at 1,024/1,024, one row: 8 keys a tile (32 KiB of K and V a
        # stage) fit two blocks an SM; 16 do not.
        _, tile, _, _ = stream_decode_plan(32, 4, 1, 4096, 1024, 1024, 2, 2,
                                           132)
        assert tile == 8
        assert stream_decode_smem(8, 1, 1024, 1024, 2, 2) <= STREAM_SMEM_TWO
        assert stream_decode_smem(16, 1, 1024, 1024, 2, 2) > STREAM_SMEM_TWO
        # Narrow rows take the longest tile.
        assert stream_decode_plan(32, 8, 1, 4096, 64, 64, 2, 2, 132)[1] == \
            STREAM_MAX_TILE

    @pytest.mark.parametrize("sms", [66, 132, 264])
    def test_splits_fill_the_sms(self, sms):
        # 32 x 4 one-row caches of 4,096 keys at 1,024/1,024 in bf16 (two
        # blocks an SM): about STREAM_WAVES blocks a slot, unless that would
        # cut a split below its least keys.
        _, _, splits, _ = stream_decode_plan(32, 4, 1, 4096, 1024, 1024, 2, 2,
                                             sms)
        slots = STREAM_WAVES * 2 * sms
        assert splits == min(-(-slots // 128),
                             4096 // STREAM_SPLIT_MIN_KEYS)

    def test_splits_keep_their_least_keys(self):
        # One cache, one row: the split count stops at the least keys.
        _, tile, splits, split_keys = stream_decode_plan(
            1, 1, 1, 4096, 64, 64, 2, 2, 132)
        assert split_keys == STREAM_SPLIT_MIN_KEYS
        assert splits == 4096 // STREAM_SPLIT_MIN_KEYS

    def test_one_split_when_the_caches_fill_the_sms(self):
        # 256 x 8 one-row caches: 2,048 blocks already give each of 264
        # slots STREAM_WAVES blocks or more.
        assert 2048 >= STREAM_WAVES * 264
        assert stream_decode_plan(256, 8, 1, 4096, 1024, 1024, 2, 2,
                                  132)[2:] == (1, 4096)

    def test_rows_too_wide_for_a_block_raise(self):
        with pytest.raises(ValueError, match="too wide"):
            stream_decode_plan(1, 1, 1, 16, 20000, 20000, 4, 4, 132)


class TestTunedSplits:
    """``tuned_decode_splits``: the cache split of the tuned decode's ring
    kernel, from the shapes, its tile and the SM count alone."""

    @pytest.mark.parametrize("b,h,cap,tile,sms", [
        (32, 32, 4096, 64, 132), (32, 1, 4096, 64, 132), (1, 1, 16, 64, 132),
        (3, 2, 300, 128, 132), (7, 1, 4096, 32, 132), (1, 1, 1 << 20, 64, 132),
        (2, 2, 65, 64, 8)])
    def test_splits_cover_the_cache_in_whole_tiles(self, b, h, cap, tile,
                                                   sms):
        splits, split_keys = tuned_decode_splits(b, h, cap, tile, sms)
        assert splits >= 1 and split_keys % tile == 0
        # Every key in one split, no split empty by construction.
        assert (splits - 1) * split_keys < cap <= splits * split_keys

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
    def test_one_split_at_the_serve_shape(self, dtype):
        # 32 sequences x 32 heads of 128 against a 4096-key cache: 1024
        # blocks already fill 132 SMs, so no merge is launched.
        tile = tuned_decode_tile(dtype, 128, 128)
        assert tile and tuned_decode_splits(32, 32, 4096, tile, 132) == (
            1, 4096)

    def test_splits_fill_the_sms_at_32_caches(self):
        # One head of 32 sequences: 32 blocks would leave 100 of 132 SMs
        # idle; the split brings the grid to about TUNED_BLOCKS_PER_SM an SM.
        tile = tuned_decode_tile(torch.bfloat16, 128, 128)
        splits, _ = tuned_decode_splits(32, 1, 4096, tile, 132)
        slots = TUNED_BLOCKS_PER_SM * 132
        assert slots - 32 < splits * 32 <= slots

    def test_a_cache_shorter_than_a_tile_is_one_tile(self):
        assert tuned_decode_splits(1, 1, 16, 64, 132) == (1, 64)
        assert tuned_decode_splits(1, 1, 65, 64, 132) == (1, 128)
        # One sequence, one head: the split count stops at the least keys.
        splits, split_keys = tuned_decode_splits(1, 1, 4096, 64, 132)
        assert split_keys == TUNED_SPLIT_MIN_KEYS
        assert splits == 4096 // TUNED_SPLIT_MIN_KEYS

    @pytest.mark.parametrize("dtype,d,dv,tile", [
        (torch.bfloat16, 64, 64, 128), (torch.float16, 128, 128, 64),
        (torch.bfloat16, 256, 256, 32), (torch.float16, 128, 64, 64),
        (torch.float16, 8, 8, 128), (torch.float32, 128, 128, 32),
        (torch.float32, 32, 32, 128), (torch.float16, 66, 66, 0),
        (torch.float32, 256, 256, 16), (torch.float32, 130, 128, 0),
        (torch.float32, 192, 192, 16), (torch.float32, 256, 128, 16)])
    def test_tiles_by_dtype_and_head_dims(self, dtype, d, dv, tile):
        assert tuned_decode_tile(dtype, d, dv) == tile


class TestBuild:
    def _fake_nvcc(self, tmp_path, script):
        bindir = tmp_path / "bin"
        bindir.mkdir()
        nvcc = bindir / "nvcc"
        nvcc.write_text("#!/bin/sh\n" + script)
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
        return bindir

    def test_missing_nvcc_is_an_error(self, tmp_path, monkeypatch):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
            _build.load("decode_attention")
        with pytest.raises(_build.KernelBuildError, match="no kernel source"):
            _build.load("no_such_kernel")

    def test_builds_every_source_for_sm90a_then_only_stale_ones(
            self, tmp_path, monkeypatch):
        # A stand-in nvcc that records its arguments and writes the -o file.
        log = tmp_path / "args"
        bindir = self._fake_nvcc(tmp_path, (
            f'echo "$@" >> {log}\n'
            'while [ "$1" != "-o" ]; do shift; done\n'
            'echo lib > "$2"\n'))
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}/bin")
        built = _build.build_all()
        sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
        assert sorted(built) == sources and "decode_attention" in sources
        for name in sources:
            assert _build.library_path(name).read_text() == "lib\n"
        args = log.read_text()
        assert "arch=compute_90a,code=sm_90a" in args and "-shared" in args
        assert _build.build_all() == {}                 # nothing stale
        assert sorted(_build.build_all(force=True)) == sources

    def test_a_newer_header_makes_every_source_stale(self, tmp_path,
                                                    monkeypatch):
        # Sources that include a header are rebuilt when only it changed.
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        for name in ("one.cu", "two.cu", "shared.cuh"):
            (csrc / name).write_text("// source\n")
        log = tmp_path / "args"
        bindir = self._fake_nvcc(tmp_path, (
            f'echo "$@" >> {log}\n'
            'while [ "$1" != "-o" ]; do shift; done\n'
            'echo lib > "$2"\n'))
        monkeypatch.setattr(_build, "CSRC", csrc)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}/bin")
        assert sorted(_build.build_all()) == ["one", "two"]
        assert _build.build_all() == {}

        def age(path, seconds):
            when = time.time() - seconds
            os.utime(path, (when, when))

        # The header edited after both libraries were built.
        for name in ("one", "two"):
            age(_build.library_path(name), 60)
        age(csrc / "shared.cuh", 30)
        assert sorted(_build.build_all()) == ["one", "two"]
        assert _build.build_all() == {}
        # Only one source edited after its library.
        age(_build.library_path("two"), 20)
        age(csrc / "two.cu", 10)
        assert sorted(_build.build_all()) == ["two"]

    def test_failed_compile_raises_with_log_and_leaves_no_library(
            self, tmp_path, monkeypatch):
        bindir = self._fake_nvcc(tmp_path, 'echo "error: bad kernel"\n'
                                           'exit 2\n')
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}/bin")
        with pytest.raises(_build.KernelBuildError, match="bad kernel"):
            _build.build_all()
        assert list((tmp_path / "build").iterdir()) == []
