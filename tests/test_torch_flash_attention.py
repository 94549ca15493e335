"""The GPU port's flash attention held against the JAX package's.

On the CPU the port's ``flash_attention`` runs its plain PyTorch version,
``reference_attention`` (the CUDA kernel runs only on the card, where
``chip_smoke.py`` holds it against the same plain version). The same seeded
numpy inputs go through the JAX package's Pallas ``flash_attention`` in
interpret mode and its ``reference_attention``, case for case as in
``tests/test_compute.py``'s ``TestFlashAttention``, at its tolerances (f32
2e-5, bf16 3e-2). Also here: the wrapper's input checks, which run
without a card.
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
from k8s_dra_driver_tpu_torch.compute import _build
from k8s_dra_driver_tpu_torch.compute.flashattention import (
    HEAD_DIM_MULTIPLE,
    MAX_HEAD_DIM,
    flash_attention,
)
from k8s_dra_driver_tpu_torch.compute.ringattention import (
    reference_attention,
)

F32_TOL = 2e-5
BF16_TOL = 3e-2


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
        MAX_HEAD_DIM + HEAD_DIM_MULTIPLE, 32), (32, MAX_HEAD_DIM + 16)])
    def test_head_dim_limits_raise(self, d, dv):
        q, k = _rand((1, 1, 32, d), 1), _rand((1, 1, 32, d), 2)
        v = _rand((1, 1, 32, dv), 3)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(*_t(q, k, v))

    def test_largest_head_dims_pass(self):
        q = _rand((1, 1, 16, MAX_HEAD_DIM), 4)
        (tq,) = _t(q)
        out = flash_attention(tq, tq, tq)
        assert tuple(out.shape) == (1, 1, 16, MAX_HEAD_DIM)

    def test_bad_inputs_raise(self):
        tq, tk, tv = _t(*(_rand((1, 2, 32, 16), s) for s in (5, 6, 7)))
        cases = [
            (tq, tk, tv[:, :, :16]),                    # v's sequence
            (tq, tk[:, :1], tv),                        # k's heads
            (tq, tk.transpose(2, 3), tv),               # k's layout
            (tq.double(), tk.double(), tv.double()),    # dtype
            (tq.bfloat16(), tk, tv),                    # mixed dtypes
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
        ("_Z5otheri", "_Z5otheri")])
    def test_kernel_names(self, mangled, name):
        names = ["flash_bf16_kernel", "flash_f32_kernel",
                 "decode_attention_kernel"]
        assert chip_smoke.kernel_name(mangled, names) == name
