"""The GPU port's decode attention held against the JAX package's.

On the CPU the port's ``flash_attention_decode`` runs its plain PyTorch
version (the CUDA kernel runs only on the card, where ``chip_smoke.py``
holds it against the same plain version). The same seeded numpy inputs go
through the JAX package's ``xla_decode_attention`` and its Pallas
``flash_attention_decode`` in interpret mode, at the JAX tests' shapes and
tolerances (f32 1e-4, bf16 3e-2, poisoned tail 1e-5). Also here: the
wrapper's input checks and the kernel build's error paths, which run
without a card.
"""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.compute.flashattention import (
    flash_attention_decode as jax_flash_decode,
)
from k8s_dra_driver_tpu.compute.serving import xla_decode_attention
from k8s_dra_driver_tpu_torch.compute import _build
from k8s_dra_driver_tpu_torch.compute.flashattention import (
    MAX_HEAD_DIM,
    MAX_Q_LEN,
    check_kernel_head_dims,
    decode_attention_reference,
    flash_attention_decode,
)

B, H, D, CAP = 4, 2, 8, 64
LENS = np.array([1, 17, 33, 64], np.int32)


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
    # group of 8 on the card), and head dims over 256 (refused on the card).
    @pytest.mark.parametrize("ql,d,dv", [
        (1, 16, 32), (4, 32, 16), (16, D, D), (MAX_Q_LEN + 1, D, D),
        (20, 16, 24), (1, 2 * MAX_HEAD_DIM, 2 * MAX_HEAD_DIM)])
    def test_shapes_jax_takes(self, ql, d, dv):
        q, k, v = _inputs(17, ql, d=d, dv=dv)
        pallas = np.asarray(jax_flash_decode(q, k, v, LENS, block_k=16,
                                             interpret=True))
        out = flash_attention_decode(*_t(q, k, v, LENS), block_k=16)
        assert tuple(out.shape) == (B, H, ql, dv)
        assert _max_abs(out.numpy(), pallas) < 1e-4
        assert _max_abs(out.numpy(),
                        xla_decode_attention(q, k, v, LENS)) < 1e-4

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
                                      (1, MAX_HEAD_DIM + 1), (0, D)])
    def test_kernel_limits_raise(self, ql, d):
        # An empty q raises everywhere; more than 8 rows and a head dim over
        # 256 run on the CPU path, and the head dim is refused for the
        # CUDA kernel only.
        q, k, v = _inputs(1, ql, d=d, cap=16)
        args = _t(q, k, v, LENS)
        if ql < 1:
            with pytest.raises(ValueError, match="q_len"):
                flash_attention_decode(*args)
            return
        out = flash_attention_decode(*args)
        assert torch.equal(out, decode_attention_reference(*args))
        if d > MAX_HEAD_DIM:
            with pytest.raises(ValueError, match=f"up to {MAX_HEAD_DIM}"):
                check_kernel_head_dims("decode_attention", d, d)
        else:
            check_kernel_head_dims("decode_attention", d, d)

    def test_bad_inputs_raise(self):
        q, k, v = _inputs(2, 1)
        tq, tk, tv, tl = _t(q, k, v, LENS)
        cases = [
            (tq, tk, tv, tl.long()),                       # lengths dtype
            (tq, tk, tv, tl[:2]),                          # lengths shape
            (tq, tk, tv[:, :, :32], tl),                   # k/v mismatch
            (tq, tk.transpose(2, 3), tv, tl),              # k layout
            (tq.double(), tk.double(), tv.double(), tl),   # dtype
            (tq.bfloat16(), tk, tv, tl),                   # mixed dtypes
            (tq[0], tk, tv, tl),                           # q rank
        ]
        for case in cases:
            with pytest.raises(ValueError):
                flash_attention_decode(*case)

    def test_non_contiguous_raises(self):
        q, k, v = _inputs(4, 1)
        tq, tk, tv, tl = _t(q, k, v, LENS)
        strided = torch.empty(B, H, CAP, 2 * D)[..., ::2]
        strided.copy_(tk)
        assert not strided.is_contiguous()
        with pytest.raises(ValueError, match="contiguous"):
            flash_attention_decode(tq, strided, tv, tl)


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

    def test_failed_compile_raises_with_log_and_leaves_no_library(
            self, tmp_path, monkeypatch):
        bindir = self._fake_nvcc(tmp_path, 'echo "error: bad kernel"\n'
                                           'exit 2\n')
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}/bin")
        with pytest.raises(_build.KernelBuildError, match="bad kernel"):
            _build.build_all()
        assert list((tmp_path / "build").iterdir()) == []
