"""The port's entry points: the burn-in step, and the multi-device dry run.

``entry()`` mirrors the JAX package's ``__graft_entry__.entry``: the
healthcheck workload (one bf16 pre-LN block at d_model 512, d_ff 2048) and
an input ``x`` of [8, 128, 512] bf16, both made from fixed seeds, on the
current CUDA device unless ``device`` says otherwise.

``dryrun_multichip(n_devices)`` mirrors ``__graft_entry__.dryrun_multichip``:
step 1, the control plane on mock nodes (``mock_cluster_rendezvous`` and
``mock_cd_flow``, CPU objects whatever the device), then steps 2-6 on
``n_devices`` ranks: NCCL over the machine's GPUs, or gloo ranks with
``device="cpu"``.
"""

from __future__ import annotations

import tempfile
from typing import Any, Callable, Optional, Union

import torch
import torch.distributed as dist

from k8s_dra_driver_tpu_torch.api.computedomain import (
    NODE_LABEL_CD,
    new_compute_domain,
)
from k8s_dra_driver_tpu_torch.api.configs import API_VERSION
from k8s_dra_driver_tpu_torch.cdi.spec import claim_spec_env
from k8s_dra_driver_tpu_torch.compute import _dist
from k8s_dra_driver_tpu_torch.compute._device import _resolve_device
from k8s_dra_driver_tpu_torch.compute.burnin import (
    burnin_step,
    transformer_block_params,
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
from k8s_dra_driver_tpu_torch.compute.ringattention import (
    make_ring_attention,
    reference_attention,
    seq_block,
)
from k8s_dra_driver_tpu_torch.compute.sharded import (
    make_mesh,
    sharded_train_step,
    train_state,
)
from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.pkg.errors import is_permanent
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller import (
    ComputeDomainController,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon import (
    ComputeDomainDaemon,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin import (
    CD_DRIVER_NAME,
    CdDriver,
    CdDriverConfig,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)

#: The dry run's tolerance (the JAX dry run's and its tests' f32 limit).
DRYRUN_TOL = 2e-5

#: Device classes of the GPU and ComputeDomain plugins, as a cluster's
#: deployment defines them.
GPU_CLASS = "gpu.nvidia.com"
CHANNEL_CLASS = "compute-domain-default-channel.nvidia.com"
DAEMON_CLASS = "compute-domain-daemon.nvidia.com"


def entry(device: Union[str, torch.device, None] = None
          ) -> tuple[Callable, tuple]:
    """(fn, example_args): ``fn(*example_args)`` runs one burn-in step."""
    dev = _resolve_device(device)
    params = transformer_block_params(d_model=512, d_ff=2048, device=dev)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((8, 128, 512), generator=gen).to(torch.bfloat16).to(dev)
    return burnin_step, (params, x)


def _check(cond: bool, what) -> None:
    """The dry run's checks: raise AssertionError (under ``-O`` too)."""
    if not cond:
        raise AssertionError(what)


def mock_cluster_rendezvous(num_hosts: int = 2, profile: str = "h100-8"
                            ) -> dict[int, dict[str, str]]:
    """The allocation path on mock nodes (``__graft_entry__.
    _mock_cluster_rendezvous``): one fake API server, the GPU kubelet plugin
    on each of ``num_hosts`` nodes of ``profile``, and one claim per node
    for all its GPUs (``allocationMode: All``, CEL on ``hostIndex``),
    allocated and prepared. Asserts that each node's CDI spec makes
    exactly its own GPUs visible, and returns each node's claim-wide env."""
    client = FakeClient()
    host_env: dict[int, dict[str, str]] = {}
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        drivers, libs = [], []
        for host in range(num_hosts):
            libs.append(MockDeviceLib(profile, host_index=host))
            drivers.append(GpuDriver(client, DriverConfig(
                node_name=f"host{host}", state_dir=f"{tmp}/state-{host}",
                cdi_root=f"{tmp}/cdi-{host}", env={}, retry_timeout=5.0),
                device_lib=libs[-1]).start())
        slices = client.list("ResourceSlice")
        _check(len(slices) == num_hosts,
               f"want {num_hosts} slices, got {len(slices)}")
        alloc = Allocator(client)
        for host, (driver, lib) in enumerate(zip(drivers, libs)):
            claim = alloc.allocate(client.create(new_object(
                "ResourceClaim", f"cd-worker-{host}", "default",
                api_version="resource.k8s.io/v1",
                spec={"devices": {"requests": [{"name": "gpu", "exactly": {
                    "allocationMode": "All",
                    "selectors": [{"cel": {"expression":
                        f"device.attributes['type'] == 'gpu' && "
                        f"device.attributes['hostIndex'] == {host}"}}],
                }}]}})))
            uid = claim["metadata"]["uid"]
            res = driver.prepare_resource_claims([claim])[uid]
            if res.error is not None:
                raise res.error
            env = claim_spec_env(driver.cdi.read_claim_spec(uid))
            visible = env["CUDA_VISIBLE_DEVICES"].split(",")
            want = [g.uuid for g in lib.enumerate_gpus()]
            _check(sorted(visible) == sorted(want), (host, visible, want))
            host_env[host] = env
    everyone = [u for env in host_env.values()
                for u in env["CUDA_VISIBLE_DEVICES"].split(",")]
    _check(len(everyone) == len(set(everyone)), "a GPU on two nodes")
    return host_env


def expected_node_ranks(num_hosts: int, profile: str) -> list[int]:
    """The rank each mock node must get: its place in the global
    ``(clique, index)`` order, the index being the node's host index in a
    multi-node NVLink domain and 0 in a clique of one node."""
    infos = [MockDeviceLib(profile, host_index=h).node_info()
             for h in range(num_hosts)]
    order = sorted(range(num_hosts), key=lambda h: (
        infos[h].domain_clique_id,
        infos[h].host_index if infos[h].clique_hosts > 1 else 0))
    return [order.index(h) for h in range(num_hosts)]


def mock_cd_flow(num_hosts: int = 2, profile: str = "h100-8"
                 ) -> dict[int, dict[str, str]]:
    """The ComputeDomain choreography on mock nodes (``__graft_entry__.
    _mock_cd_flow``): the CD reconciled into its DaemonSet and templates; a
    CD kubelet plugin per node publishing channel devices; workload channel
    claims REFUSED (retryably) while the CD is not Ready, with the node
    label applied anyway; per-node daemons reporting Ready into their
    cliques, and the CD Ready; then every claim prepares with its node's
    rendezvous: its own ``NODE_RANK`` (the global ``(clique, index)``
    order), one ``MASTER_ADDR`` (rank 0's node) and ``NNODES ==
    num_hosts``. Returns each node's channel env."""
    client = FakeClient()
    for host in range(num_hosts):
        client.create(new_object("Node", f"host{host}"))
    for name, kind in ((CHANNEL_CLASS, "channel"), (DAEMON_CLASS, "daemon")):
        client.create(new_object("DeviceClass", name, spec={"selectors": [
            {"cel": {"expression": f"device.attributes['type'] == '{kind}'"}}
        ]}))

    # Cluster control plane: the CD reconciled into DaemonSet + templates.
    cd = client.create(new_compute_domain("dryrun-cd", num_nodes=num_hosts))
    cd_uid = cd["metadata"]["uid"]
    controller = ComputeDomainController(client)
    controller.reconcile(client.get("ComputeDomain", "dryrun-cd", "default"))
    for kind, name in (("DaemonSet", "dryrun-cd-daemon"),
                       ("ResourceClaimTemplate", "dryrun-cd-channel")):
        _check(client.try_get(kind, name, "default") is not None,
               f"the controller made no {kind} {name}")

    host_env: dict[int, dict[str, str]] = {}
    with tempfile.TemporaryDirectory(prefix="dryrun-cd-") as tmp:
        # Node agents: one CD kubelet plugin per node.
        drivers = [CdDriver(client, CdDriverConfig(
            node_name=f"host{h}", state_dir=f"{tmp}/cd-state-{h}",
            cdi_root=f"{tmp}/cd-cdi-{h}", env={}, retry_timeout=0.3),
            device_lib=MockDeviceLib(profile, host_index=h)).start()
            for h in range(num_hosts)]

        def channel_claim(host: int) -> dict:
            return client.create(new_object(
                "ResourceClaim", f"cd-chan-{host}", "default",
                api_version="resource.k8s.io/v1",
                spec={"devices": {
                    "requests": [{"name": "channel", "exactly": {
                        "deviceClassName": CHANNEL_CLASS,
                        "allocationMode": "ExactCount", "count": 1,
                        "selectors": [{"cel": {"expression":
                            f"device.attributes['hostIndex'] == {host}"}}]}}],
                    "config": [{"requests": ["channel"], "opaque": {
                        "driver": CD_DRIVER_NAME,
                        "parameters": {
                            "apiVersion": API_VERSION,
                            "kind": "ComputeDomainChannelConfig",
                            "domainID": cd_uid,
                            "allocationMode": "Single"}}}]}}))

        alloc = Allocator(client)
        claims = [alloc.allocate(channel_claim(h)) for h in range(num_hosts)]

        # Phase 1: the CD is not Ready, so prepare is refused, retryably.
        uid0 = claims[0]["metadata"]["uid"]
        err = drivers[0].prepare_resource_claims([claims[0]])[uid0].error
        _check(err is not None and not is_permanent(err),
               f"expected a retryable not-ready refusal, got {err!r}")
        # Phase 2: the refused prepare still labelled the node, which is
        # what draws the CD's DaemonSet there (the codependent flow).
        labels = client.get("Node", "host0")["metadata"].get("labels") or {}
        _check(labels.get(NODE_LABEL_CD) == cd_uid, labels)

        # Phase 3: daemons come up on every node and report Ready.
        for h in range(num_hosts):
            ComputeDomainDaemon(
                client=client, device_lib=MockDeviceLib(profile,
                                                        host_index=h),
                cd_uid=cd_uid, cd_name="dryrun-cd", node_name=f"host{h}",
                hostname=f"host{h}").sync_once()
        controller.reconcile(client.get("ComputeDomain", "dryrun-cd",
                                        "default"))
        status = client.get("ComputeDomain", "dryrun-cd", "default")["status"]
        _check(status["status"] == "Ready"
               and status["readyNodes"] == num_hosts, status)

        # Phase 4: every claim prepares with its node's rendezvous.
        ranks = expected_node_ranks(num_hosts, profile)
        for host, (claim, driver) in enumerate(zip(claims, drivers)):
            uid = claim["metadata"]["uid"]
            res = driver.prepare_resource_claims([client.get(
                "ResourceClaim", f"cd-chan-{host}", "default")])[uid]
            if res.error is not None:
                raise res.error
            host_env[host] = claim_spec_env(driver.cdi.read_claim_spec(uid))
    head = f"host{ranks.index(0)}"
    for host, env in host_env.items():
        _check(env["NODE_RANK"] == str(ranks[host])
               and env["MASTER_ADDR"] == head
               and env["NNODES"] == str(num_hosts)
               and env["COMPUTE_DOMAIN_UUID"] == cd_uid, (host, env, ranks))
    return host_env


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    err = (got.float() - want.float()).abs()
    if not bool((err <= DRYRUN_TOL + DRYRUN_TOL * want.float().abs()).all()):
        raise AssertionError(f"{what}: max |error| {float(err.max())} over "
                             f"rtol = atol = {DRYRUN_TOL}")
    return float(err.max())


def _rank_dryrun(rank: int, world: int, device: torch.device
                 ) -> dict[str, Any]:
    out: dict[str, Any] = {"world": world, "backend": dist.get_backend(),
                           "device": str(device)}

    # 2. Data plane: the sharded train step over a dp x tp mesh.
    mesh = make_mesh()
    params = train_state(mesh)
    step, make_batch = sharded_train_step(mesh)
    tokens, targets = make_batch(batch=2 * mesh.size(0), seq=16)
    _, loss = step(params, tokens, targets)
    loss = float(loss)
    if not (loss == loss and loss > 0):
        raise AssertionError(f"bad loss {loss}")
    out["mesh"] = {"dp": mesh.size(0), "tp": mesh.size(1)}
    out["loss"] = loss

    # 3. An explicit collective over the whole world: sum of the ranks.
    x = torch.tensor([float(rank)], device=device)
    dist.all_reduce(x)
    if float(x) != float(sum(range(world))):
        raise AssertionError(f"all-reduce wrong: {float(x)}")
    out["allreduce"] = float(x)

    # 4. Long context: ring attention over an sp ring of every rank,
    #    against the unsharded reference.
    sp_mesh = _dist.make_device_mesh((world,), ("sp",))
    gen = torch.Generator().manual_seed(11)
    kq = torch.randn((1, 2, 8 * world, 16), generator=gen).to(device)
    blk = seq_block(kq, sp_mesh)
    ring = make_ring_attention(sp_mesh)(blk, blk, blk)
    out["ring_max_abs_err"] = _close(
        ring, seq_block(reference_attention(kq, kq, kq), sp_mesh), "ring")

    # 5. Expert parallelism: the largest ep of (4, 2) dividing the world
    #    (1 otherwise), dp the rest; the batch sized from dp.
    ep = max((d for d in (4, 2) if world % d == 0), default=1)
    dp = world // ep
    moe_mesh = _dist.make_device_mesh((dp, ep), ("dp", "ep"))
    dp_rank = moe_mesh.get_local_rank("dp")
    gen = torch.Generator().manual_seed(12)
    mp = moe_params(2 * ep, 16, 32, generator=gen)
    xe = torch.randn((2 * dp, 4, 16), generator=gen)
    ye = torch.randn((2 * dp, 4, 16), generator=gen)
    rows = slice(2 * dp_rank, 2 * dp_rank + 2)
    ffn, moe_shard = make_moe_ffn(moe_mesh)
    out["moe_max_abs_err"] = _close(
        ffn(moe_shard(mp), xe[rows].to(device)),
        moe_ffn_reference(mp, xe)[rows].to(device), "moe")
    moe_step, _ = make_moe_train_step(moe_mesh)
    _, moe_loss = moe_step(moe_shard(mp), xe[rows].to(device),
                           ye[rows].to(device))
    if float(moe_loss) != float(moe_loss):
        raise AssertionError("moe loss is NaN")
    out["moe"] = {"dp": dp, "ep": ep, "loss": float(moe_loss)}

    # 6. Pipeline parallelism: one stage per rank, GPipe over a pp ring.
    pp_mesh = _dist.make_device_mesh((world,), ("pp",))
    gen = torch.Generator().manual_seed(15)
    ppar = pipeline_params(world, 8, generator=gen)
    xs = torch.randn((world, 2, 8), generator=gen)
    ys = torch.randn((world, 2, 8), generator=gen)
    fwd, pp_shard = make_pipeline_fn(pp_mesh, n_micro=world)
    out["pipeline_max_abs_err"] = _close(
        fwd(pp_shard(ppar), xs.to(device)),
        pipeline_reference(ppar, xs).to(device), "pipeline")
    pp_step, _ = make_pipeline_train_step(pp_mesh, n_micro=world)
    _, pp_loss = pp_step(pp_shard(ppar), xs.to(device), ys.to(device))
    if float(pp_loss) != float(pp_loss):
        raise AssertionError("pipeline loss is NaN")
    out["pipeline_loss"] = float(pp_loss)
    return out


def dryrun_multichip(n_devices: int,
                     device: Union[str, torch.device, None] = None,
                     rendezvous: Optional[dict[str, str]] = None
                     ) -> dict[str, Any]:
    """Validate the multi-node path end to end, as the JAX dry run does.

    Step 1, the control plane, runs first on CPU objects whatever the
    device: ``mock_cluster_rendezvous`` and ``mock_cd_flow`` on two mock
    ``h100-8`` nodes (a clique each), as the JAX dry run's on two hosts.

    Then the compute plane on ``n_devices`` ranks (one per GPU unless
    ``device="cpu"``, then gloo ranks), as the JAX dry run's steps 2-6 do
    on its virtual devices, the ranks meeting at a channel claim's
    ``rendezvous`` env when one is given (``_dist.run_ranks``): (2) one
    sharded
    train step over a balanced dp x tp mesh; (3) an all-reduce of every
    rank's index; (4) ring attention over an sp ring of every rank against
    the unsharded reference; (5) the MoE FFN over a dp x ep mesh against
    its dense reference, and one train step; (6) the GPipe pipeline, one
    stage per rank, against sequential stages, and one train step. Each
    check within rtol = atol = 2e-5; any failure raises.

    Returns rank 0's summary: world size, backend, device, the mesh
    shapes, losses and the largest errors."""
    mock_cluster_rendezvous()
    mock_cd_flow()
    return _dist.run_ranks(_rank_dryrun, n_devices, device=device,
                           rendezvous=rendezvous)[0]
