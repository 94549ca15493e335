"""The GPU port's flash attention held against the JAX package's.

On the CPU the port's ``flash_attention`` runs its plain PyTorch version,
``reference_attention`` (the CUDA kernel runs only on the card, where
``chip_smoke.py`` holds it against the same plain version). The same seeded
numpy inputs go through the JAX package's Pallas ``flash_attention`` in
interpret mode and its ``reference_attention``, case for case as in
``tests/test_compute.py``'s ``TestFlashAttention``, at its tolerances (f32
2e-5, bf16 3e-2), and at the inputs the CUDA kernels took only later: head
dims over 256 (257, DeepSeek-V3's absorbed-MLA 576/512), f16, and q, k and
v in different dtypes, each held to the tolerance of its narrowest input
(f32 2e-5; bf16 and f16 4e-3 + 1e-2 |ref|, the card's bf16 limit). Also
here: the wrapper's input checks and which kernel a CUDA call goes to (the
C entries mocked), which run without a card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from k8s_dra_driver_tpu.compute.flashattention import (
    flash_attention as jax_flash_attention,
)
from k8s_dra_driver_tpu.compute.ringattention import (
    reference_attention as jax_reference_attention,
)
from k8s_dra_driver_tpu_torch.compute import _build, flashattention
from k8s_dra_driver_tpu_torch.compute.flashattention import (
    CLUSTER_DV_COLS,
    CLUSTER_GROUP_COLS,
    CLUSTER_MAX_CTAS,
    HEAD_DIM_MULTIPLE,
    TUNED_HEAD_DIM,
    cluster_flash_plan,
    flash_attention,
    padded_head_dims,
    tuned_kernel_takes,
)
from k8s_dra_driver_tpu_torch.compute.ringattention import (
    reference_attention,
)

F32_TOL = 2e-5
BF16_TOL = 3e-2
# (atol, rtol) where any input is bf16 or f16: the card's bf16 limit
# (chip_smoke.FLASH_BF16_TOL).
HALF_TOL = (4e-3, 1e-2)
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in arrays]


def _close(out, ref, tol, msg=""):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _agrees_with_jax(q, k, v, dtypes, causal, block):
    """The port's CPU path and the JAX kernel (interpret mode) on the same
    numpy inputs cast to ``dtypes`` (q's, k's, v's): the output is in q's
    dtype and within the tolerance of the narrowest input."""
    tq, tk, tv = dtypes
    jax_out = jax_flash_attention(
        jnp.asarray(q, JNP[tq]), jnp.asarray(k, JNP[tk]),
        jnp.asarray(v, JNP[tv]), block_q=block, block_k=block,
        causal=causal, interpret=True)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(TORCH[t])
            for a, t in ((q, tq), (k, tk), (v, tv))]
    out = flash_attention(*args, block_q=block, block_k=block, causal=causal)
    assert out.dtype == TORCH[tq] and str(jax_out.dtype) == str(
        jnp.dtype(JNP[tq]))
    assert tuple(out.shape) == q.shape[:3] + (v.shape[3],)
    atol, rtol = ((F32_TOL, F32_TOL) if set(dtypes) == {"f32"}
                  else HALF_TOL)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jax_out.astype(jnp.float32)),
                               atol=atol, rtol=rtol,
                               err_msg=f"{dtypes} causal={causal}")


class TestAgainstJax:
    def test_matches_reference(self):
        q = _rand((2, 3, 256, 64), 1)
        k = _rand((2, 3, 256, 64), 2)
        v = _rand((2, 3, 256, 64), 3)
        pallas = jax_flash_attention(q, k, v, block_q=64, block_k=128,
                                     interpret=True)
        out = flash_attention(*_t(q, k, v), block_q=64, block_k=128)
        assert out.dtype == torch.float32
        assert tuple(out.shape) == (2, 3, 256, 64)
        _close(out.numpy(), pallas, F32_TOL)
        _close(out.numpy(), jax_reference_attention(q, k, v), F32_TOL)

    def test_default_blocks_clamp_to_short_sequences(self):
        q = _rand((1, 2, 128, 32), 4)
        pallas = jax_flash_attention(q, q, q, interpret=True)
        (tq,) = _t(q)
        out = flash_attention(tq, tq, tq)  # defaults > seq
        _close(out.numpy(), pallas, F32_TOL)
        _close(out.numpy(), jax_reference_attention(q, q, q), F32_TOL)

    def test_sequence_not_a_multiple_of_a_kernel_tile(self):
        # S = 100: the JAX blocks clamp to 100; the CUDA kernel's 128-row
        # query and 176-key tiles are ragged.
        q, k, v = (_rand((1, 2, 100, 32), s) for s in (20, 21, 22))
        for causal in (False, True):
            pallas = jax_flash_attention(q, k, v, causal=causal,
                                         interpret=True)
            out = flash_attention(*_t(q, k, v), causal=causal)
            _close(out.numpy(), pallas, F32_TOL, f"causal={causal}")

    def test_bf16(self):
        q = _rand((1, 2, 256, 64), 5)
        jq = jnp.asarray(q, jnp.bfloat16)
        pallas = jax_flash_attention(jq, jq, jq, block_q=128, block_k=128,
                                     interpret=True).astype(jnp.float32)
        ref = jax_reference_attention(jq, jq, jq).astype(jnp.float32)
        (tq,) = _t(q, dtype=torch.bfloat16)
        out = flash_attention(tq, tq, tq, block_q=128, block_k=128)
        assert out.dtype == torch.bfloat16
        _close(out.float().numpy(), pallas, BF16_TOL)
        _close(out.float().numpy(), ref, BF16_TOL)

    def test_indivisible_sequence_rejected(self):
        q = _rand((1, 1, 192, 32), 0)
        with pytest.raises(ValueError, match="must divide"):
            jax_flash_attention(q, q, q, block_q=128, block_k=128,
                                interpret=True)
        (tq,) = _t(q)
        before = flash_attention.launches
        with pytest.raises(ValueError, match="must divide"):
            flash_attention(tq, tq, tq, block_q=128, block_k=128)
        assert flash_attention.launches == before

    def test_causal(self):
        q = _rand((1, 2, 256, 64), 6)
        k = _rand((1, 2, 256, 64), 7)
        v = _rand((1, 2, 256, 64), 8)
        pallas = jax_flash_attention(q, k, v, block_q=64, block_k=64,
                                     causal=True, interpret=True)
        out = flash_attention(*_t(q, k, v), block_q=64, block_k=64,
                              causal=True)
        _close(out.numpy(), pallas, F32_TOL)
        _close(out.numpy(), jax_reference_attention(q, k, v, causal=True),
               F32_TOL)

    @pytest.mark.parametrize("bq,bk", [(64, 128), (128, 64), (256, 256)])
    def test_causal_unequal_blocks(self, bq, bk):
        q = _rand((1, 2, 256, 32), 10)
        k = _rand((1, 2, 256, 32), 11)
        v = _rand((1, 2, 256, 32), 12)
        pallas = jax_flash_attention(q, k, v, block_q=bq, block_k=bk,
                                     causal=True, interpret=True)
        out = flash_attention(*_t(q, k, v), block_q=bq, block_k=bk,
                              causal=True)
        _close(out.numpy(), pallas, F32_TOL, f"bq={bq} bk={bk}")
        _close(out.numpy(), jax_reference_attention(q, k, v, causal=True),
               F32_TOL, f"bq={bq} bk={bk}")

    def test_causal_first_row_not_nan(self):
        # Row 0 attends only to key 0: its output is v's row 0.
        q = _rand((1, 1, 128, 32), 9)
        (tq,) = _t(q)
        out = flash_attention(tq, tq, tq, block_q=64, block_k=64,
                              causal=True)
        assert not torch.isnan(out).any()
        np.testing.assert_allclose(out[0, 0, 0].numpy(), q[0, 0, 0],
                                   rtol=1e-5)
        pallas = jax_flash_attention(q, q, q, block_q=64, block_k=64,
                                     causal=True, interpret=True)
        _close(out.numpy(), pallas, F32_TOL)

    # The CUDA kernel's tile edges: S = 1 and 64 are less than one 128-row
    # query tile and one 176-key tile, 64 is exactly one 64-key tile of the
    # 256 bucket, 129 and 320 are not multiples of 128 and leave a ragged
    # key tile; the last case is the 256 bucket, whose 128 query rows meet
    # two 64-key tiles on the causal diagonal.
    @pytest.mark.parametrize("seq,d,causal", [
        (1, 64, False), (1, 64, True), (64, 64, False), (64, 64, True),
        (129, 64, False), (129, 64, True), (320, 64, False),
        (320, 64, True), (320, 256, True)])
    def test_kernel_tile_edges(self, seq, d, causal):
        q, k, v = (_rand((1, 2, seq, d), s) for s in (50, 51, 52))
        pallas = jax_flash_attention(q, k, v, block_q=seq, block_k=seq,
                                     causal=causal, interpret=True)
        out = flash_attention(*_t(q, k, v), block_q=seq, block_k=seq,
                              causal=causal)
        assert tuple(out.shape) == (1, 2, seq, d)
        _close(out.numpy(), pallas, F32_TOL, f"S={seq} causal={causal}")
        _close(out.numpy(), jax_reference_attention(q, k, v, causal=causal),
               F32_TOL, f"S={seq} causal={causal}")

    # The f32 route's 64-row query tiles and 64-key tiles: S = 63, 65 and
    # 128 (a tile less one, one and a row, two), at d = 128 and at its
    # widest bucket, 576/512 (S 1, 64, 129 and 320 are above).
    @pytest.mark.parametrize("seq", [63, 65, 128])
    @pytest.mark.parametrize("d,dv", [(128, 128), (576, 512)])
    @pytest.mark.parametrize("causal", [False, True])
    def test_f32_tile_edges_match_pallas(self, seq, d, dv, causal):
        q, k = _rand((1, 2, seq, d), 53), _rand((1, 2, seq, d), 54)
        v = _rand((1, 2, seq, dv), 55)
        _agrees_with_jax(q, k, v, ("f32",) * 3, causal, block=seq)

    def test_value_dim_differs_from_key_dim(self):
        q, k = _rand((1, 2, 128, 32), 13), _rand((1, 2, 128, 32), 14)
        v = _rand((1, 2, 128, 64), 15)
        for causal in (False, True):
            pallas = jax_flash_attention(q, k, v, block_q=64, block_k=64,
                                         causal=causal, interpret=True)
            out = flash_attention(*_t(q, k, v), block_q=64, block_k=64,
                                  causal=causal)
            assert tuple(out.shape) == (1, 2, 128, 64)
            _close(out.numpy(), pallas, F32_TOL, f"causal={causal}")

    # Head dims that are not multiples of 16 (8, 40) and one over the CUDA
    # kernel's 256 (320): the JAX function takes each, and so does the
    # port's CPU path. On the card the wrapper pads 8 and 40 to 16 and 48.
    @pytest.mark.parametrize("d,dv,causal", [
        (8, 8, False), (8, 8, True), (40, 40, False), (40, 40, True),
        (40, 24, False), (320, 320, False), (320, 320, True)])
    def test_head_dims_jax_takes(self, d, dv, causal):
        q, k = _rand((1, 2, 64, d), 60), _rand((1, 2, 64, d), 61)
        v = _rand((1, 2, 64, dv), 62)
        pallas = jax_flash_attention(q, k, v, block_q=32, block_k=32,
                                     causal=causal, interpret=True)
        out = flash_attention(*_t(q, k, v), block_q=32, block_k=32,
                              causal=causal)
        assert tuple(out.shape) == (1, 2, 64, dv)
        _close(out.numpy(), pallas, F32_TOL, f"d={d} dv={dv}")


    # Head dims over 256 at short sequences, every dtype: 257 (past the tuned
    # kernels by one), DeepSeek-V3's absorbed-MLA widths (576/512) and a
    # value dim over 256 beside a narrow key dim.
    @pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
    @pytest.mark.parametrize("d,dv", [(257, 257), (576, 512), (64, 640)])
    @pytest.mark.parametrize("causal", [False, True])
    def test_wide_head_dims_match_pallas(self, d, dv, dtype, causal):
        q, k = _rand((1, 2, 32, d), 70), _rand((1, 2, 32, d), 71)
        v = _rand((1, 2, 32, dv), 72)
        _agrees_with_jax(q, k, v, (dtype,) * 3, causal, block=16)

    @pytest.mark.parametrize("causal", [False, True])
    def test_f16(self, causal):
        q, k, v = (_rand((1, 2, 128, 64), s) for s in (73, 74, 75))
        _agrees_with_jax(q, k, v, ("f16",) * 3, causal, block=64)
        jq, jk, jv = (jnp.asarray(a, jnp.float16) for a in (q, k, v))
        ref = jax_reference_attention(jq, jk, jv, causal=causal)
        out = flash_attention(*_t(q, k, v, dtype=torch.float16),
                              causal=causal)
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   atol=HALF_TOL[0], rtol=HALF_TOL[1])

    # q, k and v in different dtypes, as JAX takes them.
    @pytest.mark.parametrize("dtypes", [
        ("f32", "bf16", "bf16"), ("f32", "f16", "f16"),
        ("bf16", "f16", "f16"), ("f16", "bf16", "bf16"),
        ("f32", "f32", "bf16"), ("bf16", "bf16", "f32")])
    @pytest.mark.parametrize("d,dv", [(64, 64), (40, 24), (320, 288)])
    @pytest.mark.parametrize("causal", [False, True])
    def test_mixed_dtypes_match_pallas(self, d, dv, dtypes, causal):
        q, k = _rand((1, 2, 64, d), 76), _rand((1, 2, 64, d), 77)
        v = _rand((1, 2, 64, dv), 78)
        _agrees_with_jax(q, k, v, dtypes, causal, block=32)

    # The any-dtype flash kernel's calls at wide heads (1,024/1,024: a
    # cluster of 4 CTAs, 2 groups of d each; 64/640: one CTA for each 256
    # columns of dv) with K and V in different dtypes, held to JAX
    # (interpret mode) through the plain version.
    @pytest.mark.parametrize("dtypes", [
        ("f32", "f32", "bf16"), ("bf16", "bf16", "f32"),
        ("f16", "bf16", "f16")])
    @pytest.mark.parametrize("d,dv", [(1024, 1024), (64, 640)])
    @pytest.mark.parametrize("causal", [False, True])
    def test_k_and_v_apart_match_pallas_at_wide_heads(self, d, dv, dtypes,
                                                      causal):
        q, k = _rand((1, 1, 64, d), 83), _rand((1, 1, 64, d), 84)
        v = _rand((1, 1, 64, dv), 85)
        _agrees_with_jax(q, k, v, dtypes, causal, block=32)


class TestReferenceAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_f32_matches_jax(self, causal):
        q, k, v = (_rand((2, 2, 96, 32), s) for s in (30, 31, 32))
        out = reference_attention(*_t(q, k, v), causal=causal)
        ref = jax_reference_attention(q, k, v, causal=causal)
        _close(out.numpy(), ref, F32_TOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_bf16_matches_jax(self, causal):
        q, k, v = (_rand((1, 2, 64, 32), s) for s in (33, 34, 35))
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        ref = jax_reference_attention(jq, jk, jv, causal=causal)
        out = reference_attention(*_t(q, k, v, dtype=torch.bfloat16),
                                  causal=causal)
        assert out.dtype == torch.bfloat16
        _close(out.float().numpy(), ref.astype(jnp.float32), BF16_TOL)


class TestWrapper:
    def test_cpu_tensors_take_the_plain_version_and_launch_nothing(self):
        args = _t(*(_rand((1, 2, 64, 16), s) for s in (40, 41, 42)))
        before = flash_attention.launches
        for causal in (False, True):
            out = flash_attention(*args, causal=causal)
            assert torch.equal(out, reference_attention(*args,
                                                        causal=causal))
        assert flash_attention.launches == before

    @pytest.mark.parametrize("d,dv", [(24, 32), (32, 40), (
        TUNED_HEAD_DIM + HEAD_DIM_MULTIPLE, 32), (32, TUNED_HEAD_DIM + 16)])
    def test_head_dim_limits_raise(self, d, dv):
        # No head dim is refused: the CPU path is JAX's result at every
        # one, and on the card bf16 and f16 head dims up to TUNED_HEAD_DIM
        # are padded to multiples of 16 for the tuned kernel; wider ones,
        # and f32 at any width, go unpadded to the general kernel.
        q, k = _rand((1, 1, 32, d), 1), _rand((1, 1, 32, d), 2)
        v = _rand((1, 1, 32, dv), 3)
        out = flash_attention(*_t(q, k, v))
        assert torch.equal(out, reference_attention(*_t(q, k, v)))
        _close(out.numpy(), jax_flash_attention(q, k, v, interpret=True),
               F32_TOL)
        padded = padded_head_dims(d, dv)
        assert padded == (-(-d // HEAD_DIM_MULTIPLE) * HEAD_DIM_MULTIPLE,
                          -(-dv // HEAD_DIM_MULTIPLE) * HEAD_DIM_MULTIPLE)
        for dtype in (torch.bfloat16, torch.float16):
            assert tuned_kernel_takes(
                "flash_attention", *_t(q, k, v, dtype=dtype), *padded) == (
                    max(d, dv) <= TUNED_HEAD_DIM)
        assert not tuned_kernel_takes("flash_attention", *_t(q, k, v),
                                      *padded)
        assert not hasattr(flashattention, "MAX_HEAD_DIM")

    def test_largest_head_dims_pass(self):
        q = _rand((1, 1, 16, TUNED_HEAD_DIM), 4)
        (tq,) = _t(q)
        out = flash_attention(tq, tq, tq)
        assert tuple(out.shape) == (1, 1, 16, TUNED_HEAD_DIM)

    def test_bad_inputs_raise(self):
        tq, tk, tv = _t(*(_rand((1, 2, 32, 16), s) for s in (5, 6, 7)))
        cases = [
            (tq, tk, tv[:, :, :16]),                    # v's sequence
            (tq, tk[:, :1], tv),                        # k's heads
            (tq, tk.transpose(2, 3), tv),               # k's layout
            (tq.double(), tk.double(), tv.double()),    # dtype
            (tq, tk, tv.double()),                      # v's dtype
            (tq[0], tk, tv),                            # q's rank
            (tq, tk, tv[0]),                            # v's rank
            (tq[:0], tk[:0], tv[:0]),                   # empty batch
        ]
        for case in cases:
            with pytest.raises(ValueError):
                flash_attention(*case)

    def test_non_contiguous_raises(self):
        tq, tk, tv = _t(*(_rand((1, 2, 32, 16), s) for s in (8, 9, 10)))
        strided = torch.empty(1, 2, 32, 32)[..., ::2]
        strided.copy_(tk)
        assert not strided.is_contiguous()
        with pytest.raises(ValueError, match="contiguous"):
            flash_attention(tq, strided, tv)

    def test_other_devices_raise(self):
        meta = [torch.empty(1, 1, 32, 16, device="meta") for _ in range(3)]
        with pytest.raises(ValueError, match="unsupported device"):
            flash_attention(*meta)
        (tq,) = _t(_rand((1, 1, 32, 16), 11))
        with pytest.raises(ValueError, match="different devices"):
            flash_attention(tq, meta[1], meta[2])


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


class TestRouting:
    """Which C entry a CUDA call reaches, with what: the launch routine
    that ``flash_attention`` runs on CUDA tensors, given CPU tensors and a
    mocked library (no card here)."""

    @pytest.fixture
    def lib(self, monkeypatch):
        lib = _FakeLib()
        monkeypatch.setattr(_build, "load", lambda name: lib)
        return lib

    def _launch(self, d, dv, dtypes, causal=False):
        q, k = _rand((2, 3, 16, d), 80), _rand((2, 3, 16, d), 81)
        v = _rand((2, 3, 16, dv), 82)
        args = [torch.from_numpy(a).to(TORCH[t])
                for a, t in ((q, dtypes[0]), (k, dtypes[1]), (v, dtypes[2]))]
        before = flash_attention.launches
        out = flashattention._launch_flash(*args, causal, stream=0)
        assert flash_attention.launches == before + 1
        assert out.shape == (2, 3, 16, dv) and out.dtype == TORCH[dtypes[0]]

    def test_1024_wide_call_goes_to_the_general_entry(self, lib):
        # Past the wide route's 576/512: the any-dtype flash entry of a
        # 16-bit q, with the cluster plan of 1,024/1,024 (4 CTAs of 256
        # columns of dv, 2 groups of 128 columns of d each).
        self._launch(1024, 1024, ("bf16",) * 3, causal=True)
        assert set(lib.entries) == {"cluster_flash_q16_run",
                                    "cluster_flash_q16_error_string"}
        (call,) = lib.entries["cluster_flash_q16_run"].calls
        # bh, S, padded d and dv, causal, scale, q/k/v dtype codes, CTAs a
        # cluster, groups a CTA, V panels a CTA, stream
        assert call[4:] == (6, 16, 1024, 1024, 1, pytest.approx(1 / 32),
                            1, 1, 1, 4, 2, 8, 0)

    @pytest.mark.parametrize("d,dv,dtypes,entry,tail", [
        (128, 128, ("f16",) * 3, "flash_attention_f16", (128, 128)),
        (40, 24, ("bf16",) * 3, "flash_attention_bf16", (48, 32)),
        # f16 at d = 264 takes the wide kernels, padded like the tuned ones
        (264, 64, ("f16",) * 3, "flash_attention_wide_f16", (272, 64)),
        # K and V sharing a dtype apart from q's: the any-dtype entry of
        # q's width (the mixed entry's before the one TF32 flash body),
        # padded, with K's and V's codes and the cluster plan (one CTA, one
        # group, 4 V panels)
        (40, 24, ("f32", "bf16", "bf16"), "cluster_flash_q32_run",
         (48, 32, 0, pytest.approx(40 ** -0.5), 1, 1, 1, 1, 4)),
        # K and V apart: the any-dtype entry of q's width, padded, with the
        # codes and the cluster plan (one CTA, one group, 4 V panels)
        (64, 64, ("bf16", "f16", "f32"), "cluster_flash_q16_run",
         (64, 64, 0, pytest.approx(1 / 8), 1, 2, 0, 1, 1, 4)),
        (40, 24, ("f32", "f32", "bf16"), "cluster_flash_q32_run",
         (48, 32, 0, pytest.approx(40 ** -0.5), 0, 1, 1, 1, 4))])
    def test_tuned_and_general_entries(self, lib, d, dv, dtypes, entry,
                                       tail):
        # The tuned and wide kernels get head dims padded to multiples of 16
        # and the true d's scale; the any-dtype ones padded dims, the codes
        # (the entry of an f32 q takes K's and V's alone) and the cluster
        # plan.
        self._launch(d, dv, dtypes)
        (call,) = lib.entries[entry].calls
        assert call[4:6] == (6, 16)
        if entry.endswith("_run"):
            assert call[6:-1] == tail
        else:
            assert call[6:-1] == tail + (0, pytest.approx(d ** -0.5))


    @pytest.mark.parametrize("dtype", ["bf16", "f16"])
    @pytest.mark.parametrize("d,dv,padded", [
        (257, 257, (272, 272)), (320, 320, (320, 320)),
        (576, 512, (576, 512))])
    @pytest.mark.parametrize("causal", [False, True])
    def test_wide_head_dims_reach_the_wide_entry(self, lib, dtype, d, dv,
                                                 padded, causal):
        self._launch(d, dv, (dtype,) * 3, causal=causal)
        assert set(lib.entries) == {f"flash_attention_wide_{dtype}",
                                    "flash_attention_error_string"}
        (call,) = lib.entries[f"flash_attention_wide_{dtype}"].calls
        # bh, S, padded d and dv, causal, the true d's scale, stream
        assert call[4:] == (6, 16, *padded, int(causal),
                            pytest.approx(d ** -0.5), 0)

    @pytest.mark.parametrize("d,dv,dtypes", [
        (576, 512, ("bf16", "f16", "f16")),
        (320, 320, ("f16", "bf16", "bf16")), (1024, 1024, ("f16",) * 3),
        (64, 640, ("bf16",) * 3), (592, 64, ("bf16",) * 3)])
    def test_what_the_wide_kernels_do_not_take_stays_general(
            self, lib, d, dv, dtypes):
        # Padded dims past 576/512 and mixed dtypes up to them (the mixed
        # entry's before the one TF32 flash body) take the any-dtype entry
        # of q's width.
        self._launch(d, dv, dtypes)
        assert set(lib.entries) == {"cluster_flash_q16_run",
                                    "cluster_flash_q16_error_string"}
        assert not flashattention.wide_kernel_takes(
            *[torch.zeros(1, dtype=TORCH[t]) for t in dtypes],
            *padded_head_dims(d, dv))


    # Every all-f32 call up to padded 576/512 (the f32 entry's before the
    # one TF32 flash body) takes the any-dtype kernel (3xTF32), at any S,
    # causal off and on: one call of its f32-q entry with head dims padded
    # to multiples of 16, the true d's scale, K's and V's codes and the
    # cluster plan (clusters of 2 at 576/512). ``f32_kernel_takes``, one of
    # ``decode_route``'s tests, still takes these dims.
    @pytest.mark.parametrize("d,dv,padded", [
        (128, 128, (128, 128)), (40, 24, (48, 32)), (256, 8, (256, 16)),
        (576, 512, (576, 512))])
    @pytest.mark.parametrize("causal", [False, True])
    def test_f32_reaches_the_any_dtype_entry(self, lib, d, dv, padded,
                                             causal):
        self._launch(d, dv, ("f32",) * 3, causal=causal)
        assert set(lib.entries) == {"cluster_flash_q32_run",
                                    "cluster_flash_q32_error_string"}
        (call,) = lib.entries["cluster_flash_q32_run"].calls
        # bh, S, padded d and dv, causal, the true d's scale, K's and V's
        # codes, the cluster plan, stream
        assert call[4:] == (6, 16, *padded, int(causal),
                            pytest.approx(d ** -0.5), 0, 0,
                            *cluster_flash_plan(*padded), 0)
        assert flashattention.f32_kernel_takes(
            *[torch.zeros(1) for _ in range(3)], *padded)

    @pytest.mark.parametrize("d,dv,dtypes", [
        (1024, 1024, ("f32",) * 3), (64, 640, ("f32",) * 3),
        (592, 64, ("f32",) * 3), (128, 128, ("f32", "bf16", "bf16")),
        (576, 512, ("f32", "f32", "bf16")),
        (40, 24, ("bf16", "bf16", "f32"))])
    def test_f32_past_576_512_and_f32_mixes_take_the_any_dtype_entry(
            self, lib, d, dv, dtypes):
        # f32 past padded 576/512, and every mix with an f32 operand, K and
        # V apart or sharing a dtype apart from q's (the mixed entry's
        # before the one TF32 flash body): the any-dtype entry of q's width.
        # Of ``decode_route``'s tests, ``mixed_kernel_takes`` takes the
        # second kind and ``f32_kernel_takes`` none.
        self._launch(d, dv, dtypes)
        mixed = dtypes[1] == dtypes[2] != dtypes[0]
        source = ("cluster_flash_q32" if dtypes[0] == "f32"
                  else "cluster_flash_q16")
        assert set(lib.entries) == {f"{source}_run",
                                    f"{source}_error_string"}
        assert flashattention.mixed_kernel_takes(
            *[torch.zeros(1, dtype=TORCH[t]) for t in dtypes],
            *padded_head_dims(d, dv)) == mixed
        assert not flashattention.f32_kernel_takes(
            *[torch.zeros(1, dtype=TORCH[t]) for t in dtypes],
            *padded_head_dims(d, dv))

    # Decode keeps its f32 and mixed routes over 256 (the TF32 decode body):
    # only flash moved onto the any-dtype kernel.
    @pytest.mark.parametrize("d,dv,dtypes,route", [
        (576, 512, ("f32",) * 3, "f32"), (264, 64, ("f32",) * 3, "f32"),
        (576, 512, ("f32", "bf16", "bf16"), "mixed"),
        (320, 320, ("bf16", "f32", "f32"), "mixed"),
        (40, 264, ("f16", "bf16", "bf16"), "mixed")])
    def test_decode_keeps_the_f32_and_mixed_routes_over_256(
            self, d, dv, dtypes, route):
        q = torch.zeros((2, 3, 4, d), dtype=TORCH[dtypes[0]])
        k = torch.zeros((2, 3, 64, d), dtype=TORCH[dtypes[1]])
        v = torch.zeros((2, 3, 64, dv), dtype=TORCH[dtypes[2]])
        assert flashattention.decode_route(q, k, v) == route

    # One TF32 flash body: no mixed flash source, no f32 flash entry, and
    # the f32 and mixed body keeps only its decode form.
    @pytest.mark.parametrize("source,absent", [
        ("mixed_flash.cu", None),
        ("flash_attention.cu", ("f32tc", "flash_attention_f32tc")),
        ("f32tc_attention.cuh", ("kDecode", "causal", "f32tc_flash_kernel",
                                 "launch_flash"))])
    def test_one_tf32_flash_body(self, source, absent):
        path = _build.CSRC / source
        if absent is None:
            assert not path.exists()
        else:
            text = path.read_text()
            assert not [word for word in absent if word in text]


class TestMixedRouting:
    """Where a CUDA flash call in a mix of dtypes goes (the C entries
    mocked): the any-dtype entry of q's width, with each operand's code and
    ``cluster_flash_plan``'s plan, at every head dim, causal off and on;
    up to padded 576/512 with K and V sharing a dtype apart from q's, that
    was the mixed entry's before the one TF32 flash body."""

    @pytest.fixture
    def lib(self, monkeypatch):
        lib = _FakeLib()
        monkeypatch.setattr(_build, "load", lambda name: lib)
        return lib

    _launch = TestRouting._launch

    # Each class at each of the mixed entry's old head-dim buckets (4/4,
    # 8/8 and 18/8 panels) and a padded one: bh, S, padded dims, causal, the
    # true d's scale, then q's (16-bit q only), K's and V's dtype codes and
    # the cluster plan.
    @pytest.mark.parametrize("dtypes,codes", [
        (("f32", "bf16", "bf16"), (0, 1)), (("f32", "f16", "f16"), (0, 2)),
        (("bf16", "f32", "f32"), (1, 0)), (("f16", "f32", "f32"), (2, 0)),
        (("bf16", "f16", "f16"), (1, 2)), (("f16", "bf16", "bf16"), (2, 1))])
    @pytest.mark.parametrize("d,dv,padded", [
        (128, 128, (128, 128)), (256, 256, (256, 256)),
        (576, 512, (576, 512)), (40, 24, (48, 32))])
    @pytest.mark.parametrize("causal", [False, True])
    def test_mixed_dtypes_reach_the_any_dtype_entry(self, lib, dtypes, codes,
                                                    d, dv, padded, causal):
        self._launch(d, dv, dtypes, causal=causal)
        source = ("cluster_flash_q32" if dtypes[0] == "f32"
                  else "cluster_flash_q16")
        assert set(lib.entries) == {f"{source}_run",
                                    f"{source}_error_string"}
        (call,) = lib.entries[f"{source}_run"].calls
        q_code, kv_code = codes
        assert call[4:] == (6, 16, *padded, int(causal),
                            pytest.approx(d ** -0.5),
                            *(q_code, kv_code, kv_code)[q_code == 0:],
                            *cluster_flash_plan(*padded), 0)

    @pytest.mark.parametrize("d,dv,dtypes", [
        (128, 128, ("f32", "f32", "bf16")), (128, 128, ("bf16", "f16", "bf16")),
        (1024, 1024, ("f32", "bf16", "bf16")),
        (64, 640, ("bf16", "f32", "f32")),
        (592, 64, ("f16", "bf16", "bf16"))])
    def test_k_and_v_apart_and_wide_mixes_take_the_any_dtype_entry(
            self, lib, d, dv, dtypes):
        # The any-dtype entry of q's width, at padded dims, with each
        # operand's code and the cluster plan of those dims.
        self._launch(d, dv, dtypes)
        source = ("cluster_flash_q32" if dtypes[0] == "f32"
                  else "cluster_flash_q16")
        assert set(lib.entries) == {f"{source}_run",
                                    f"{source}_error_string"}
        (call,) = lib.entries[f"{source}_run"].calls
        dp, dvp = padded_head_dims(d, dv)
        codes = tuple({"f32": 0, "bf16": 1, "f16": 2}[t] for t in dtypes)
        assert call[4:] == (6, 16, dp, dvp, 0, pytest.approx(d ** -0.5),
                            *codes[dtypes[0] == "f32":],
                            *cluster_flash_plan(dp, dvp), 0)

    def test_the_entry_gets_the_callers_k_and_v(self, lib):
        # At head dims that are multiples of 16 nothing is cast or copied:
        # the entry gets the caller's tensors in their own dtypes.
        q = torch.zeros((2, 3, 16, 64))
        k, v = (torch.zeros((2, 3, 16, 64), dtype=torch.bfloat16)
                for _ in range(2))
        out = flashattention._launch_flash(q, k, v, False, stream=0)
        (call,) = lib.entries["cluster_flash_q32_run"].calls
        assert call[:4] == tuple(t.data_ptr() for t in (q, k, v, out))
        assert out.dtype == torch.float32


class TestClusterPlan:
    """``cluster_flash_plan``: the any-dtype flash kernel's cluster, its
    CTAs' shares of d and their V panels, from the padded head dims."""

    @pytest.mark.parametrize("d,dv,plan", [
        (1024, 1024, (4, 2, 8)), (64, 640, (1, 1, 8)), (128, 128, (1, 1, 4)),
        (80, 144, (1, 1, 8)), (1024, 64, (1, 8, 4)), (576, 512, (2, 3, 8)),
        (64, 4096, (1, 1, 8)), (144, 4096, (8, 1, 8)),
        (2048, 2048, (8, 2, 8))])
    def test_plans(self, d, dv, plan):
        assert cluster_flash_plan(d, dv) == plan

    @pytest.mark.parametrize("d", [16, 64, 80, 320, 1024, 1040, 4096])
    @pytest.mark.parametrize("dv", [16, 128, 144, 640, 1024, 2064, 4096])
    def test_the_cluster_covers_d_and_its_ctas_dv(self, d, dv):
        cluster, groups, vp = cluster_flash_plan(d, dv)
        assert 1 <= cluster <= CLUSTER_MAX_CTAS
        # The CTAs' groups cover d, no CTA wholly past it but the ones a
        # narrow d leaves without a group.
        assert cluster * groups * CLUSTER_GROUP_COLS >= d
        assert (groups - 1) * cluster * CLUSTER_GROUP_COLS < d
        # A cluster's columns cover dv, or each of its cluster items'
        # CLUSTER_MAX_CTAS slices, or, where d is one group, one CTA takes
        # each slice; one CTA of 4 panels only where dv fits.
        cols = cluster * vp * 32
        assert (cols >= dv or cluster == CLUSTER_MAX_CTAS
                or (cluster == 1 and d <= CLUSTER_GROUP_COLS))
        assert vp == 8 or (cluster == 1 and dv <= CLUSTER_DV_COLS // 2)
        # No CTA of the cluster wholly past dv.
        assert (cluster - 1) * vp * 32 < dv


class TestBuildReport:
    """What ``chip_smoke.phase_build`` reads: the toolkit's disassembly of a
    built library and the kernels' names in it."""

    def test_disassemble_runs_cuobjdump_beside_nvcc(self, tmp_path,
                                                    monkeypatch):
        bindir = tmp_path / "bin"
        bindir.mkdir()
        for tool, body in (
                ("nvcc", 'while [ "$1" != "-o" ]; do shift; done\n'
                         'echo lib > "$2"\n'),
                ("cuobjdump", 'echo "Function : k $@"\n')):
            path = bindir / tool
            path.write_text("#!/bin/sh\n" + body)
            path.chmod(0o755)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}/bin")
        out = _build.disassemble("flash_attention")
        lib = _build.library_path("flash_attention")
        assert lib.read_text() == "lib\n"            # built first
        assert out.split() == ["Function", ":", "k", "-sass", str(lib)]

    @pytest.mark.parametrize("mangled,name", [
        ("_ZN12_GLOBAL__N_117flash_bf16_kernelILi128EEEv14CUtensorMap_stS1_"
         "S1_P13__nv_bfloat16iiifi", "flash_bf16_kernel<128>"),
        ("_ZN12_GLOBAL__N_116flash_f32_kernelEPKfS2_S2_Pfiiifi",
         "flash_f32_kernel"),
        ("_ZN41_GLOBAL__N__dec3f_19_decode_attention_cu_7de7d0af23decode_"
         "attention_kernelILi8EfEEvPKT0_S3_", "decode_attention_kernel<8>"),
        ("_ZN12_GLOBAL__N_123decode_attention_kernelIfLi1ELi4ELb1EEEvPKT_",
         "decode_attention_kernel<1,4,1>"),
        ("_ZN12_GLOBAL__N_14wide17wide_flash_kernelI13__nv_bfloat16EEv14CU"
         "tensorMap_stS3_S3_NS0_4ArgsE", "wide_flash_kernel<bf16>"),
        ("_ZN12_GLOBAL__N_14wide24wide_decode_merge_kernelI6__halfEEvPKfS4_"
         "PT_iii", "wide_decode_merge_kernel<f16>"),
        ("_ZN12_GLOBAL__N_123decode_attention_kernelI6__halfLi1ELi8ELb1EEEv"
         "PKT_", "decode_attention_kernel<f16,1,8,1>"),
        ("_ZN52_GLOBAL__N__636dec3f_19_decode_attention_cu_7de7d0af4ring18"
         "decode_ring_kernelI13__nv_bfloat16Li1ELi16EEEvPKT_",
         "decode_ring_kernel<bf16,1,16>"),
        ("_ZN12_GLOBAL__N_15f32tc19f32tc_decode_kernelILi18ELi8ELb0ELb1EEEv"
         "14CUtensorMap_stS2_S2_NS0_4ArgsE", "f32tc_decode_kernel<18,8,0,1>"),
        ("_ZN12_GLOBAL__N_16cflash20cluster_flash_kernelILi8ELb0ELb0ELb1EEE"
         "v14CUtensorMap_stS2_S2_NS0_4ArgsE",
         "cluster_flash_kernel<8,0,0,1>"),
        ("_Z5otheri", "_Z5otheri")])
    def test_kernel_names(self, mangled, name):
        # A name inside another (flash_kernel in wide_flash_kernel) does not
        # hide the longer one.
        names = ["flash_bf16_kernel", "flash_f32_kernel",
                 "decode_attention_kernel", "flash_kernel",
                 "wide_flash_kernel", "wide_decode_merge_kernel",
                 "decode_ring_kernel", "f32tc_decode_kernel",
                 "cluster_flash_kernel"]
        assert chip_smoke.kernel_name(mangled, names) == name
