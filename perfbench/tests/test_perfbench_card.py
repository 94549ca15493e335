"""On the card: the decode kernel within each configuration's ``attn_err``
limit and the TF32 control past it, at each configuration's widths on a
cache a test run can hold (8 slots of 4,096 positions, lengths drawn
across it). Skips without a CUDA device."""

import json
import os

import pytest
import torch

from perfbench import check, reference

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as _f:
    CONFIGS = [c["name"] for c in json.load(_f)["configs"]]


@pytest.mark.card
@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("seed", [3_000_000_201, 3_000_000_202,
                                  3_000_000_203])
def test_the_kernel_passes_and_the_control_fails(card, config, seed):
    from k8s_dra_driver_tpu_torch.compute.flashattention import (
        flash_attention_decode,
    )
    with open(os.path.join(HERE, "configs", f"{config}.json")) as f:
        c = json.load(f)
    limit = c["checks"]["attn_err"]
    shape = (8, c["num_attention_heads"], 4096, c["head_dim"])
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(1, 4097, (8,), generator=g, dtype=torch.int32)
    lens[0], lens[1] = 1, 4096
    sound = check.kernel_error(flash_attention_decode, shape, torch.float32,
                               card, lens, seed)
    control = check.kernel_error(reference.tf32_attend, shape,
                                 torch.float32, card, lens, seed)
    assert sound <= limit < control, (sound, limit, control)
