"""All-reduce bandwidth: measured with ``torch.distributed``, and modeled for
an NVSwitch node.

The JAX package's ``compute/collectives.py`` measures ``lax.psum`` bus
bandwidth over a device mesh and models it against the ICI line rate of a
TPU slice. Here:

- ``psum_bench``: measured all-reduce *bus bandwidth* of
  ``dist.all_reduce`` over the world group of ``n`` ranks: NCCL over the
  GPUs of one machine, or gloo ranks on the CPU. Fewer than two devices
  raise: one GPU has no link to measure.
- ``nvlink_line_rate``: the line-rate ceiling of one NVSwitch node from the
  GPU's NVLink links and per-link rate (``gpulib/chip.py``). Every GPU's
  links go to the switches, which connect every pair at full rate, so the
  ceiling is each GPU's own egress, the same for every GPU.
- ``modeled_allreduce`` and ``sensitivity_sweep``: the ring all-reduce
  time model (latency + wire bytes / egress) over that ceiling. Their rows
  carry ``"kind": "modeled"``: they are arithmetic on published rates and
  an assumed per-step latency, never a measurement.

Definitions (the NCCL "busbw" convention, as the JAX module's):
- each device holds a shard of S bytes; all-reduce makes every device hold
  the elementwise sum;
- a bandwidth-optimal all-reduce (reduce-scatter + all-gather) moves
  ``2*S*(d-1)/d`` bytes through each device's links;
- bus bandwidth = that wire volume / wall time, per device: comparable to
  the device's one-way link egress.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from k8s_dra_driver_tpu_torch.compute import _dist
from k8s_dra_driver_tpu_torch.gpulib.chip import GpuSpec

#: The per-step latency the model assumes where a caller gives none: the
#: JAX model's 1 us, kept as an assumption (not measured on any GPU);
#: ``sensitivity_sweep`` shows the model's answer from 0.5 to 5 us.
DEFAULT_HOP_LATENCY_S = 1e-6


def allreduce_wire_bytes(shard_bytes: int, n_devices: int) -> float:
    """Bytes a bandwidth-optimal all-reduce moves through EACH device."""
    if n_devices < 2:
        return 0.0
    return 2.0 * shard_bytes * (n_devices - 1) / n_devices


def _rank_psum(rank: int, world: int, device: torch.device,
               shard_elems: int, reps: int) -> dict:
    # Rank i contributes a shard filled with i+1, so every element of the
    # sum must be d(d+1)/2.
    x = torch.full((shard_elems,), float(rank + 1), dtype=torch.float32,
                   device=device)

    def allreduce_sum() -> float:
        y = x.clone()
        dist.all_reduce(y)
        return float(y[:2].sum())   # host fetch of a dependent scalar: fence

    expect = world * (world + 1) / 2 * 2
    got = allreduce_sum()            # warm + verify
    if abs(got - expect) > 1e-3 * max(1.0, abs(expect)):
        raise RuntimeError(f"all-reduce bench wrong result: {got} != "
                           f"{expect}")
    best = float("inf")
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        allreduce_sum()
        best = min(best, time.perf_counter() - t0)
    return {"seconds": best, "device": _device_name(device)}


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def psum_bench(shard_elems: int = 1 << 22, reps: int = 5,
               n_devices: Optional[int] = None,
               device: Union[str, torch.device, None] = None) -> dict:
    """Measured all-reduce bus bandwidth over ``n_devices`` ranks (every
    GPU of the machine unless given; ``device="cpu"`` for gloo ranks).

    Each rank contributes a distinct f32 shard of ``shard_elems``; each
    timed all-reduce ends in a host fetch of a scalar that depends on its
    result. Returns the best of ``reps`` as ``seconds`` (rank 0's), the
    achieved ``bus_gbps``, ``platform``, the device's name and ``"kind":
    "measured"``. Raises ``ValueError`` below two devices."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if n_devices is None:
        n_devices = 1 if cpu or not torch.cuda.is_available() \
            else torch.cuda.device_count()
    if n_devices < 2:
        raise ValueError(f"psum bench needs >=2 devices, got {n_devices}")
    r = _dist.run_ranks(_rank_psum, n_devices, shard_elems, reps,
                        device=device)[0]
    shard_bytes = shard_elems * 4
    wire = allreduce_wire_bytes(shard_bytes, n_devices)
    return {
        "kind": "measured",
        "n_devices": n_devices,
        "shard_bytes": shard_bytes,
        "wire_bytes_per_device": wire,
        "seconds": r["seconds"],
        "bus_gbps": wire / r["seconds"] / 1e9,
        "platform": "cpu" if cpu else "cuda",
        "device": r["device"],
    }


def nvlink_line_rate(spec: GpuSpec, n_gpus: int) -> dict:
    """Line-rate ceilings of one NVSwitch node of ``n_gpus`` GPUs of
    ``spec``: each GPU's one-way NVLink egress (links x per-link rate),
    which bounds an all-reduce's bus bandwidth, and the bisection, half
    the GPUs' egress (the all-to-all ceiling)."""
    egress = spec.nvlink_links * spec.nvlink_gbps_per_link
    return {
        "fabric": "nvswitch",
        "gpu": spec.product_name,
        "num_gpus": n_gpus,
        "nvlink_links": spec.nvlink_links,
        "per_link_gbps": spec.nvlink_gbps_per_link,
        "per_gpu_egress_gbps": egress,
        "bisection_gbps": n_gpus // 2 * egress,
    }


def modeled_allreduce(shard_bytes: int, spec: GpuSpec, n_gpus: int,
                      hop_latency_s: float = DEFAULT_HOP_LATENCY_S) -> dict:
    """Ring all-reduce time model on one NVSwitch node:
    ``t = 2*(d-1)*hop + wire / egress``. The ring runs ``2*(d-1)`` phases
    (reduce-scatter + all-gather), each paying one step's latency; the
    bandwidth term is the per-device wire volume over the per-GPU egress.
    ``pct_of_line_rate`` is the modeled bus bandwidth over that egress."""
    rate = nvlink_line_rate(spec, n_gpus)
    egress_bps = rate["per_gpu_egress_gbps"] * 1e9
    wire = allreduce_wire_bytes(shard_bytes, n_gpus)
    t = 2 * (n_gpus - 1) * hop_latency_s + wire / egress_bps
    return {
        "kind": "modeled",
        **rate,
        "shard_bytes": shard_bytes,
        "wire_bytes_per_device": wire,
        "modeled_seconds": t,
        "modeled_bus_gbps": wire / t / 1e9 if t else 0.0,
        "pct_of_line_rate": (wire / t) / egress_bps if t else 0.0,
        "hop_latency_s": hop_latency_s,
    }


def sensitivity_sweep(
    hop_latencies_s: Optional[list[float]] = None,
    shard_bytes_list: Optional[list[int]] = None,
    profiles: Optional[list[str]] = None,
) -> list[dict]:
    """How the modeled share of line rate answers its own inputs: every
    (profile, per-step latency, shard size) of the grid."""
    from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib

    hop_latencies_s = hop_latencies_s or [0.5e-6, 1e-6, 2e-6, 5e-6]
    shard_bytes_list = shard_bytes_list or [1 << 20, 16 << 20, 256 << 20,
                                            1 << 30]
    profiles = profiles or ["h100-8"]
    rows: list[dict] = []
    for profile in profiles:
        info = MockDeviceLib(profile).node_info()
        for hop in hop_latencies_s:
            for shard in shard_bytes_list:
                m = modeled_allreduce(shard, info.gpu_type.spec,
                                      info.num_gpus, hop_latency_s=hop)
                rows.append({
                    "kind": "modeled",
                    "profile": profile,
                    "hop_latency_us": hop * 1e6,
                    "shard_mib": shard / (1 << 20),
                    "pct_of_line_rate": round(m["pct_of_line_rate"], 4),
                    "modeled_bus_gbps": round(m["modeled_bus_gbps"], 1),
                })
    return rows


def fit_model_to_measurements(measurements: list[dict]) -> dict:
    """Least-squares fit of the ring model's form,
    ``t(n) = hop_eff * 2*(n-1) + wire(n) / bw_eff``, to measured
    all-reduce times across device counts: the effective parameters and
    the relative residual. A small residual says the latency + bandwidth
    decomposition describes the measured scaling."""
    ns = np.array([m["n_devices"] for m in measurements], dtype=np.float64)
    ts = np.array([m["seconds"] for m in measurements], dtype=np.float64)
    wires = np.array([m["wire_bytes_per_device"] for m in measurements],
                     dtype=np.float64)
    a = np.stack([2.0 * (ns - 1.0), wires], axis=1)
    coef, *_ = np.linalg.lstsq(a, ts, rcond=None)
    latency_dominated = False
    if coef[1] <= 0:
        # A noisy latency-dominated curve can give the bandwidth column a
        # negative weight; refit latency-only and say so rather than
        # publishing an infinite bandwidth.
        latency_dominated = True
        coef_lat, *_ = np.linalg.lstsq(a[:, :1], ts, rcond=None)
        coef = np.array([float(coef_lat[0]), 0.0])
    hop_eff, inv_bw = float(coef[0]), float(coef[1])
    pred = a @ coef
    rel_resid = np.abs(pred - ts) / np.maximum(ts, 1e-12)
    return {
        "n_points": len(measurements),
        "hop_latency_eff_us": hop_eff * 1e6,
        "bus_bandwidth_eff_gbps": (1.0 / inv_bw / 1e9) if inv_bw > 0
        else None,
        "latency_dominated": latency_dominated,
        "mean_rel_residual": float(rel_resid.mean()),
        "max_rel_residual": float(rel_resid.max()),
    }


def main(argv: Optional[list[str]] = None) -> int:
    """CLI: one JSON line with the measured bench (or, with
    ``--sweep-devices``, the bench at 2..n devices and the model's fit)."""
    p = argparse.ArgumentParser(prog="collectives-bench")
    p.add_argument("--shard-elems", type=int, default=1 << 22)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="'cpu' for gloo ranks; default every GPU")
    p.add_argument("--sweep-devices", action="store_true",
                   help="measure n_devices=2..n and fit the ring-allreduce "
                        "model's form to the curve")
    args = p.parse_args(argv)
    if args.sweep_devices:
        top = args.n_devices or torch.cuda.device_count()
        rows = [psum_bench(args.shard_elems, args.reps, n, args.device)
                for n in range(2, top + 1)]
        print(json.dumps({"measurements": rows,
                          "model_fit": fit_model_to_measurements(rows)}))
        return 0
    print(json.dumps(psum_bench(args.shard_elems, args.reps, args.n_devices,
                                args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
