"""The single-device entry point: the burn-in step with example arguments.

``entry()`` mirrors the JAX package's ``__graft_entry__.entry``: the
healthcheck workload (one bf16 pre-LN block at d_model 512, d_ff 2048) and
an input ``x`` of [8, 128, 512] bf16, both made from fixed seeds, on the
current CUDA device unless ``device`` says otherwise. The multi-device dry
run waits for the multi-GPU compute plane.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from k8s_dra_driver_tpu_torch.compute.burnin import (
    burnin_step,
    transformer_block_params,
)
from k8s_dra_driver_tpu_torch.compute._device import _resolve_device


def entry(device: Union[str, torch.device, None] = None
          ) -> tuple[Callable, tuple]:
    """(fn, example_args): ``fn(*example_args)`` runs one burn-in step."""
    dev = _resolve_device(device)
    params = transformer_block_params(d_model=512, d_ff=2048, device=dev)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((8, 128, 512), generator=gen).to(torch.bfloat16).to(dev)
    return burnin_step, (params, x)
