"""GPU compute plane: attention kernels, the serving engine, burn-in, and
the multi-GPU plane on ``torch.distributed``.

The names of the JAX package's ``compute/__init__.py``, where the port has
them: ``nvlink_line_rate`` stands where ``ici_line_rate`` does (an
NVSwitch node instead of an ICI slice), ``parse_visible_devices`` where
``parse_visible_chips`` does, and ``decode_attention_reference`` where
``xla_decode_attention`` does. The multi-GPU functions run inside a rank
of ``_dist.run_ranks``; each module's ``run_*`` starts the ranks. Nothing
here builds or loads a kernel, or starts a process, at import.
"""

from k8s_dra_driver_tpu_torch.compute.burnin import (
    burnin_step,
    matmul_flops_bench,
    transformer_block,
    transformer_block_params,
)
from k8s_dra_driver_tpu_torch.compute.collectives import (
    allreduce_wire_bytes,
    modeled_allreduce,
    nvlink_line_rate,
    psum_bench,
)
from k8s_dra_driver_tpu_torch.compute.flashattention import (
    decode_attention_reference,
    flash_attention,
    flash_attention_decode,
)
from k8s_dra_driver_tpu_torch.compute.moe import (
    make_moe_ffn,
    make_moe_train_step,
    moe_ffn_reference,
    moe_params,
)
from k8s_dra_driver_tpu_torch.compute.pipeline import (
    make_pipeline_fn,
    make_pipeline_train_step,
    pipeline_params,
    pipeline_reference,
)
from k8s_dra_driver_tpu_torch.compute.resnet import (
    data_parallel_resnet_step,
    resnet_forward,
    resnet_params,
)
from k8s_dra_driver_tpu_torch.compute.ringattention import (
    make_ring_attention,
    reference_attention,
)
from k8s_dra_driver_tpu_torch.compute.serving import (
    DecodeRequest,
    ServingEngine,
    ServingMetrics,
    parse_visible_devices,
)
from k8s_dra_driver_tpu_torch.compute.sharded import (
    make_mesh,
    sharded_train_step,
    train_state,
)

__all__ = [
    "burnin_step", "matmul_flops_bench", "transformer_block",
    "transformer_block_params",
    "make_mesh", "sharded_train_step", "train_state",
    "allreduce_wire_bytes", "nvlink_line_rate", "modeled_allreduce",
    "psum_bench",
    "make_ring_attention", "reference_attention",
    "data_parallel_resnet_step", "resnet_forward", "resnet_params",
    "flash_attention", "flash_attention_decode",
    "DecodeRequest", "ServingEngine", "ServingMetrics",
    "parse_visible_devices", "decode_attention_reference",
    "make_moe_ffn", "make_moe_train_step", "moe_ffn_reference", "moe_params",
    "make_pipeline_fn", "make_pipeline_train_step", "pipeline_params",
    "pipeline_reference",
]
