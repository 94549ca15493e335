"""The GPU port's deployment assets: every check ``tests/test_deployments.py``
makes of the TPU chart, applied to ``deployments/helm/gpu-dra-driver`` (CRDs,
DeviceClasses, the workload manifests in each toggle, the webhook's cert
modes, the ValidatingAdmissionPolicies, NetworkPolicies and RBAC),
``deployments/container/Dockerfile.gpu`` and the GPU quickstart specs, with
this file's own copy of the minimal renderer.

The chart is also tied to the port's code: every flag a template passes
parses in that binary's own argument parser, every env variable it sets is
one the binary reads, every feature gate it names is one of the port's, the
DeviceClass selectors are ``partitions.DEVICE_CLASS_SELECTORS`` and the
controller's class names, and the RBAC rules cover every (verb, kind) each
binary's client writes in a recorded run of the four binaries. The port's
manifest loader (``pkg/manifests.py``, no PyYAML) reads every spec and the
DeviceClasses exactly as ``yaml.safe_load_all`` does."""

import base64
import re
import threading
import time
from pathlib import Path

import pytest
import yaml

from k8s_dra_driver_tpu_torch.api.computedomain import new_compute_domain
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.pkg import flags
from k8s_dra_driver_tpu_torch.pkg.featuregates import (
    DEFAULT_FEATURE_GATES,
    new_feature_gates,
)
from k8s_dra_driver_tpu_torch.pkg.manifests import (
    ManifestError,
    load_all,
    load_file,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller import (
    main as controller_main,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.controller \
    import (
        CD_DRIVER_NAME,
        DEVICE_CLASS_CHANNEL,
        DEVICE_CLASS_DAEMON,
    )
from k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon import (
    main as daemon_main,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin import (
    main as cd_main,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    main as plugin_main,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import partitions
from k8s_dra_driver_tpu_torch.plugins.webhook import main as webhook_main

REPO = Path(__file__).resolve().parent.parent
CHART = REPO / "deployments" / "helm" / "gpu-dra-driver"
SPECS = REPO / "demo" / "specs" / "quickstart-gpu"
GPU_SPECS = [f"gpu-test{i}" for i in range(1, 8)]
TEMPLATES = sorted(p.name for p in (CHART / "templates").glob("*.yaml"))
PKG = "k8s_dra_driver_tpu_torch.plugins"

#: Each container command's module → the binary's argument parser.
PARSERS = {
    f"{PKG}.gpu_kubelet_plugin": plugin_main.build_parser,
    f"{PKG}.compute_domain_kubelet_plugin": cd_main.build_parser,
    f"{PKG}.compute_domain_controller": controller_main.build_parser,
    f"{PKG}.webhook": webhook_main.build_parser,
}
#: Env a template may set that no flag mirrors: the downward API's names
#: and the driver-root pair ``gpulib/root.py`` reads.
EXTRA_ENV = {"POD_NAME", "POD_NAMESPACE", "GPU_DRA_DRIVER_ROOT",
             "GPU_DRA_DRIVER_ROOT_HOST_PREFIX"}


def load_values() -> dict:
    with open(CHART / "values.yaml") as f:
        return yaml.safe_load(f)


_IF_RE = re.compile(
    r"^\s*\{\{-?\s*if\s+(not\s+)?\.Values\.([a-zA-Z0-9_.]+)\s*-?\}\}\s*$")
_END_RE = re.compile(r"^\s*\{\{-?\s*end\s*-?\}\}\s*$")


def _values_lookup(values: dict, path: str):
    cur = values
    for part in path.split("."):
        cur = cur[part]
    return cur


def render_template(text: str, values: dict) -> str:
    """Minimal helm-compatible renderer: whole-line
    {{- if .Values.a.b }} / {{- end }} blocks (nesting supported) plus
    {{ .Values.a.b }} substitutions (with ``| b64enc``) — the only template
    syntax the chart uses, by design."""
    out_lines = []
    stack: list[bool] = []
    for line in text.splitlines():
        m = _IF_RE.match(line)
        if m:
            truth = bool(_values_lookup(values, m.group(2)))
            stack.append(not truth if m.group(1) else truth)
            continue
        if _END_RE.match(line):
            assert stack, "unbalanced {{ end }}"
            stack.pop()
            continue
        if all(stack):
            out_lines.append(line)
    assert not stack, "unbalanced {{ if }}"

    def lookup(m: re.Match) -> str:
        val = str(_values_lookup(values, m.group(1)))
        if m.group(2):
            val = base64.b64encode(val.encode()).decode()
        return val
    rendered = re.sub(
        r"\{\{\s*\.Values\.([a-zA-Z0-9_.]+)\s*(\|\s*b64enc\s*)?\}\}",
        lookup, "\n".join(out_lines) + "\n")
    leftover = re.search(r"\{\{.*?\}\}", rendered)
    assert leftover is None, f"unrendered template expr: {leftover.group(0)}"
    return rendered


def rendered_docs(name: str, overrides: dict = None) -> list[dict]:
    values = load_values()
    for path, v in (overrides or {}).items():
        cur = values
        parts = path.split(".")
        for part in parts[:-1]:
            cur = cur[part]
        cur[parts[-1]] = v
    text = (CHART / "templates" / name).read_text()
    return [d for d in yaml.safe_load_all(render_template(text, values)) if d]


#: Every toggle on: the webhook (static and cert-manager), leader election,
#: a mock profile, feature gates and an API endpoint, so every container
#: and every flag renders.
ALL_ON = {"webhook.enabled": True, "controller.leaderElect": True,
          "mockProfile": "h100-8",
          "featureGates": "DynamicMIG=true,PassthroughSupport=true,"
                          "DeviceMetadata=true",
          "apiServer.endpoint": "http://127.0.0.1:8700"}


def containers(overrides: dict = None) -> list[dict]:
    out = []
    for name in TEMPLATES:
        for doc in rendered_docs(name, overrides):
            spec = (doc.get("spec") or {}).get("template", {}).get("spec", {})
            out += spec.get("containers") or []
    return out


class TestCRDs:
    def test_computedomain_crd_schema(self):
        with open(CHART / "crds" / "resource.nvidia.com_computedomains.yaml") \
                as f:
            crd = yaml.safe_load(f)
        assert crd["spec"]["group"] == "resource.nvidia.com"
        v = crd["spec"]["versions"][0]
        assert v["name"] == "v1beta1"
        spec_schema = v["schema"]["openAPIV3Schema"]["properties"]["spec"]
        assert set(spec_schema["required"]) == {"numNodes", "channel"}
        chan = spec_schema["properties"]["channel"]["properties"]
        assert "resourceClaimTemplate" in chan
        assert chan["allocationMode"]["enum"] == ["Single", "All"]
        assert v["subresources"] == {"status": {}}
        # Every spec field the port's constructor writes is schema'd.
        cd = new_compute_domain("d", num_nodes=2)
        assert set(cd["spec"]) <= set(spec_schema["properties"])
        status = v["schema"]["openAPIV3Schema"]["properties"]["status"]
        assert {"status", "readyNodes", "nodes"} <= set(status["properties"])

    def test_clique_crd_schema(self):
        from k8s_dra_driver_tpu_torch.api.computedomain import DaemonInfo
        with open(CHART / "crds" /
                  "resource.nvidia.com_computedomaincliques.yaml") as f:
            crd = yaml.safe_load(f)
        assert crd["spec"]["group"] == "resource.nvidia.com"
        daemons = (crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]
                   ["properties"]["daemons"])
        fields = set(daemons["items"]["properties"])
        # Every field DaemonInfo serializes is schema'd.
        assert set(DaemonInfo(node_name="n").to_dict()) <= fields


class TestDeviceClasses:
    def test_all_five_classes(self):
        docs = rendered_docs("deviceclasses.yaml")
        by_name = {d["metadata"]["name"]: d for d in docs}
        assert set(by_name) == {
            "gpu.nvidia.com", "mig.nvidia.com", "vfio.gpu.nvidia.com",
            "compute-domain-daemon.nvidia.com",
            "compute-domain-default-channel.nvidia.com",
        }
        # KEP-5004 extended-resource mapping on the whole-GPU class only.
        assert by_name["gpu.nvidia.com"]["spec"][
            "extendedResourceName"] == "nvidia.com/gpu"
        assert [n for n, d in by_name.items()
                if "extendedResourceName" in d["spec"]] == ["gpu.nvidia.com"]

    def test_selectors_are_the_codes(self):
        """The GPU plugin's classes carry partitions.DEVICE_CLASS_SELECTORS
        verbatim; the controller's class names select the types its plugin
        publishes."""
        by_name = {d["metadata"]["name"]: d
                   for d in rendered_docs("deviceclasses.yaml")}

        def expr(name):
            (sel,) = by_name[name]["spec"]["selectors"]
            return sel["cel"]["expression"]
        for name, want in partitions.DEVICE_CLASS_SELECTORS.items():
            assert expr(name) == want, name
        assert expr(DEVICE_CLASS_DAEMON) == \
            "device.attributes['type'] == 'daemon'"
        assert expr(DEVICE_CLASS_CHANNEL) == \
            "device.attributes['type'] == 'channel'"
        assert set(by_name) == {*partitions.DEVICE_CLASS_SELECTORS,
                                DEVICE_CLASS_DAEMON, DEVICE_CLASS_CHANNEL}

    def test_classes_select_what_the_plugins_publish(self, tmp_path):
        """Each class picks at least one published device of a plugin on
        an h100-8 node in MIG mode (the vfio class once a GPU is
        pre-bound is held by tests/test_torch_vfio.py)."""
        from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
        from k8s_dra_driver_tpu_torch.pkg.featuregates import DYNAMIC_MIG
        from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin \
            import CdDriver, CdDriverConfig
        from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
            DriverConfig,
            GpuDriver,
        )
        client = FakeClient()
        for d in load_file(CHART / "templates" / "deviceclasses.yaml"):
            client.create(d)
        client.create(new_object("Node", "n0"))
        gpu = GpuDriver(client, DriverConfig(
            node_name="n0", state_dir=str(tmp_path / "g"),
            cdi_root=str(tmp_path / "gc"), env={},
            feature_gates=new_feature_gates(f"{DYNAMIC_MIG}=true")),
            device_lib=MockDeviceLib("h100-8", mig=True)).start()
        cd = CdDriver(client, CdDriverConfig(
            node_name="n0", state_dir=str(tmp_path / "c"),
            cdi_root=str(tmp_path / "cc"), env={}),
            device_lib=MockDeviceLib("h100-8")).start()
        try:
            alloc = Allocator(client)
            for i, cls in enumerate(("gpu.nvidia.com", "mig.nvidia.com",
                                     DEVICE_CLASS_DAEMON,
                                     DEVICE_CLASS_CHANNEL)):
                client.create(new_object(
                    "ResourceClaim", f"c{i}", "default",
                    api_version="resource.k8s.io/v1",
                    spec={"devices": {"requests": [{"name": "r", "exactly": {
                        "deviceClassName": cls,
                        "allocationMode": "ExactCount", "count": 1}}]}}))
                got = alloc.allocate(client.get("ResourceClaim", f"c{i}",
                                                "default"), node="n0")
                (res,) = got["status"]["allocation"]["devices"]["results"]
                want = CD_DRIVER_NAME if "compute-domain" in cls else \
                    "gpu.nvidia.com"
                assert res["driver"] == want, (cls, res)
        finally:
            gpu.stop()
            cd.stop()


class TestWorkloadManifests:
    def test_kubeletplugin_daemonset(self):
        ds = rendered_docs("kubeletplugin.yaml")[0]
        assert ds["kind"] == "DaemonSet"
        containers = ds["spec"]["template"]["spec"]["containers"]
        by_name = {c["name"]: c for c in containers}
        assert set(by_name) == {"gpus", "compute-domains"}
        assert by_name["gpus"]["command"][-1] == f"{PKG}.gpu_kubelet_plugin"
        assert by_name["compute-domains"]["command"][-1] == \
            f"{PKG}.compute_domain_kubelet_plugin"
        env = {e["name"] for c in containers for e in c["env"]}
        assert "NODE_NAME" in env
        args = [a for c in containers for a in c["args"]]
        for flag in ("--state-dir=", "--cdi-root=", "--feature-gates=",
                     "--mock-profile="):
            assert sum(a.startswith(flag) for a in args) == 2, flag
        vols = {v["name"] for v in ds["spec"]["template"]["spec"]["volumes"]}
        assert {"plugins-registry", "plugins", "state", "cdi", "dev",
                "host-root"} <= vols
        # Driver-root resolution: the host root read-only at /host and
        # GPU_DRA_DRIVER_ROOT pointing at it (else the plugin would search
        # its own container rootfs).
        gpus = by_name["gpus"]
        env_map = {e["name"]: e.get("value") for e in gpus["env"]}
        assert env_map["GPU_DRA_DRIVER_ROOT"] == "/host"
        mount = next(m for m in gpus["volumeMounts"]
                     if m["name"] == "host-root")
        assert mount["mountPath"] == "/host" and mount["readOnly"] is True
        # The liveness probe reaches the port the health flag binds.
        port = gpus["livenessProbe"]["grpc"]["port"]
        assert f"--healthcheck-addr=0.0.0.0:{port}" in gpus["args"]

    def test_kubeletplugin_container_toggles(self):
        ds = rendered_docs("kubeletplugin.yaml",
                           {"resources.gpus.enabled": False})[0]
        names = [c["name"] for c in ds["spec"]["template"]["spec"]["containers"]]
        assert names == ["compute-domains"]
        ds = rendered_docs("kubeletplugin.yaml",
                           {"resources.computeDomains.enabled": False})[0]
        names = [c["name"] for c in ds["spec"]["template"]["spec"]["containers"]]
        assert names == ["gpus"]

    def test_webhook_disabled_by_default(self):
        assert rendered_docs("webhook.yaml") == []

    def test_webhook_enabled_renders_all_objects(self):
        docs = rendered_docs("webhook.yaml", {"webhook.enabled": True})
        kinds = {d["kind"] for d in docs}
        assert kinds == {"Secret", "Deployment", "Service",
                         "ValidatingWebhookConfiguration"}
        secret = next(d for d in docs if d["kind"] == "Secret")
        assert secret["metadata"]["name"] == "gpu-dra-driver-webhook-tls"
        pem = "-----BEGIN CERTIFICATE-----\nAAA\n-----END CERTIFICATE-----"
        docs2 = rendered_docs("webhook.yaml", {"webhook.enabled": True,
                                               "webhook.tls.cert": pem})
        s2 = next(d for d in docs2 if d["kind"] == "Secret")
        assert base64.b64decode(s2["data"]["tls.crt"]).decode() == pem
        dep = next(d for d in docs if d["kind"] == "Deployment")
        vols = dep["spec"]["template"]["spec"]["volumes"]
        assert vols[0]["secret"]["secretName"] == secret["metadata"]["name"]
        vwc = next(d for d in docs
                   if d["kind"] == "ValidatingWebhookConfiguration")
        rule = vwc["webhooks"][0]["rules"][0]
        assert set(rule["apiVersions"]) == {"v1", "v1beta1", "v1beta2"}
        assert set(rule["resources"]) == {"resourceclaims",
                                          "resourceclaimtemplates"}
        cc = vwc["webhooks"][0]["clientConfig"]["service"]
        assert cc["path"] == "/validate-resource-claim-parameters"
        c = dep["spec"]["template"]["spec"]["containers"][0]
        assert c["command"][-1] == f"{PKG}.webhook"
        # The cert files the flags name are the mounted Secret's keys.
        mount = c["volumeMounts"][0]["mountPath"]
        assert f"--tls-cert-file={mount}/tls.crt" in c["args"]
        assert f"--tls-private-key-file={mount}/tls.key" in c["args"]

    def test_webhook_cert_manager_mode(self):
        over = {"webhook.enabled": True,
                "webhook.tls.certManager.enabled": True}
        static = rendered_docs("webhook.yaml", over)
        assert "Secret" not in {d["kind"] for d in static}
        certs = rendered_docs("webhook-cert.yaml", over)
        assert {d["kind"] for d in certs} == {"Issuer", "Certificate"}
        cert = next(d for d in certs if d["kind"] == "Certificate")
        assert cert["spec"]["secretName"] == "gpu-dra-driver-webhook-tls"
        assert cert["spec"]["issuerRef"]["name"] == \
            "gpu-dra-driver-webhook-issuer"
        assert cert["spec"]["privateKey"]["rotationPolicy"] == "Always"
        vwc = next(d for d in static
                   if d["kind"] == "ValidatingWebhookConfiguration")
        assert vwc["metadata"]["annotations"][
            "cert-manager.io/inject-ca-from"] == \
            "gpu-dra-driver/gpu-dra-driver-webhook-cert"
        byo = rendered_docs("webhook-cert.yaml", {
            **over, "webhook.tls.certManager.issuerName": "corp-ca"})
        assert {d["kind"] for d in byo} == {"Certificate"}
        assert byo[0]["spec"]["issuerRef"]["name"] == "corp-ca"

    def test_webhook_cert_mode_off_renders_nothing(self):
        assert rendered_docs("webhook-cert.yaml",
                             {"webhook.enabled": True}) == []
        assert rendered_docs("webhook-cert.yaml", {
            "webhook.tls.certManager.enabled": True}) == []

    def test_validating_admission_policies(self):
        from k8s_dra_driver_tpu_torch.api import configs
        docs = rendered_docs("validatingadmissionpolicy.yaml")
        by_kind: dict = {}
        for d in docs:
            by_kind.setdefault(d["kind"], []).append(d)
        assert len(by_kind["ValidatingAdmissionPolicy"]) == 2
        assert len(by_kind["ValidatingAdmissionPolicyBinding"]) == 2
        slices = next(
            d for d in by_kind["ValidatingAdmissionPolicy"]
            if "resourceslices" in d["metadata"]["name"])
        rule = slices["spec"]["matchConstraints"]["resourceRules"][0]
        assert rule["resources"] == ["resourceslices"]
        assert "DELETE" in rule["operations"]
        assert "gpu-dra-driver-kubelet-plugin" in \
            slices["spec"]["matchConditions"][0]["expression"]
        envelope = next(
            d for d in by_kind["ValidatingAdmissionPolicy"]
            if "opaque-config" in d["metadata"]["name"])
        expr = envelope["spec"]["validations"][0]["expression"]
        # Exactly the kinds the port's webhook admits, under its version.
        named = set(re.findall(r'"([A-Za-z]+Config)"', expr))
        assert named == set(configs._KINDS)
        assert f'"{configs.API_VERSION}"' in expr
        for driver in ("gpu.nvidia.com", CD_DRIVER_NAME):
            assert f'"{driver}"' in expr
        for b in by_kind["ValidatingAdmissionPolicyBinding"]:
            assert b["spec"]["validationActions"] == ["Deny"]
        assert rendered_docs("validatingadmissionpolicy.yaml",
                             {"vap.enabled": False}) == []

    def test_networkpolicies(self):
        docs = rendered_docs("networkpolicy.yaml")
        names = {d["metadata"]["name"] for d in docs}
        assert names == {"gpu-dra-driver-default-deny-ingress",
                         "gpu-dra-driver-allow-metrics"}
        docs = rendered_docs("networkpolicy.yaml", {"webhook.enabled": True})
        names = {d["metadata"]["name"] for d in docs}
        assert "gpu-dra-driver-allow-webhook" in names
        wh = next(d for d in docs
                  if d["metadata"]["name"] == "gpu-dra-driver-allow-webhook")
        assert wh["spec"]["ingress"][0]["ports"][0]["port"] == 8443

    def test_controller_deployment(self):
        dep = rendered_docs("controller.yaml")[0]
        assert dep["kind"] == "Deployment"
        c = dep["spec"]["template"]["spec"]["containers"][0]
        assert c["command"][-1] == f"{PKG}.compute_domain_controller"
        assert "--leader-elect" not in c["args"]
        dep = rendered_docs("controller.yaml",
                            {"controller.leaderElect": True})[0]
        c = dep["spec"]["template"]["spec"]["containers"][0]
        assert "--leader-elect" in c["args"]

    def test_rbac_covers_components(self):
        docs = rendered_docs("rbac.yaml")
        kinds = [d["kind"] for d in docs]
        assert kinds.count("ServiceAccount") == 2
        assert kinds.count("ClusterRole") == 2
        assert kinds.count("ClusterRoleBinding") == 2
        roles = {d["metadata"]["name"]: d for d in docs
                 if d["kind"] == "ClusterRole"}
        plugin_rules = roles["gpu-dra-driver-kubelet-plugin"]["rules"]
        assert any("resourceslices" in r["resources"] for r in plugin_rules)
        ctrl_rules = roles["gpu-dra-driver-controller"]["rules"]
        assert any("computedomains" in r["resources"] for r in ctrl_rules)
        assert any("leases" in r["resources"] for r in ctrl_rules)
        sas = {d["metadata"]["name"] for d in docs
               if d["kind"] == "ServiceAccount"}
        for name in ("kubeletplugin.yaml", "controller.yaml"):
            dep = rendered_docs(name)[0]
            assert dep["spec"]["template"]["spec"][
                "serviceAccountName"] in sas, name


class TestChartAgainstTheCode:
    @pytest.mark.parametrize("overrides", [{}, ALL_ON],
                             ids=["defaults", "all-on"])
    def test_every_flag_parses_in_its_binary(self, overrides, monkeypatch):
        """Each container's args parse in its binary's own parser, and the
        values they set land there (not swallowed as another flag)."""
        monkeypatch.setenv("NODE_NAME", "node-0")
        seen = set()
        for c in containers(overrides):
            module = c["command"][-1]
            assert c["command"][:2] == ["python", "-m"], c["command"]
            parser = PARSERS[module]()
            by_flag = {o: a for a in parser._actions for o in a.option_strings}
            args = parser.parse_args(c.get("args") or [])
            seen.add(module)
            for a in c.get("args") or []:
                flag, _, value = a.partition("=")
                got = getattr(args, by_flag[flag].dest)
                if value:
                    assert str(got) == value, (module, flag, got)
                else:
                    assert got in ("", True), (module, flag, got)
        if overrides:
            assert seen == set(PARSERS)
        else:
            assert seen == set(PARSERS) - {f"{PKG}.webhook"}

    def test_every_env_is_read_by_its_binary(self, monkeypatch):
        monkeypatch.setenv("NODE_NAME", "node-0")
        for c in containers(ALL_ON):
            parser = PARSERS[c["command"][-1]]()
            read = {getattr(a, "env", None) for a in parser._actions}
            for e in c.get("env") or []:
                assert e["name"] in read | EXTRA_ENV, (c["name"], e["name"])

    def test_feature_gates_are_the_ports(self):
        """The gates values.yaml lists are the port's gates with their
        defaults and stages, and an ``ALL_ON`` render's gates parse."""
        text = (CHART / "values.yaml").read_text()
        listed = {m[0]: (m[1], m[2]) for m in re.findall(
            r"^#\s+([A-Za-z]+)\s+\(default (true|false),\s+(\w+)[;)]",
            text, re.M)}
        want = {name: (str(specs[-1].default).lower(), specs[-1].prerelease)
                for name, specs in DEFAULT_FEATURE_GATES.items()}
        assert listed == want
        gates = new_feature_gates(ALL_ON["featureGates"])
        for name in ("DynamicMIG", "PassthroughSupport", "DeviceMetadata"):
            assert gates.enabled(name)

    def test_rbac_covers_every_write_of_each_binary(self, tmp_path,
                                                     monkeypatch):
        writes = _recorded_writes(tmp_path, monkeypatch)
        roles = {d["metadata"]["name"]: d["rules"]
                 for d in rendered_docs("rbac.yaml")
                 if d["kind"] == "ClusterRole"}
        role_of = {"gpu-plugin": "gpu-dra-driver-kubelet-plugin",
                   "cd-plugin": "gpu-dra-driver-kubelet-plugin",
                   "daemon": "gpu-dra-driver-kubelet-plugin",
                   "controller": "gpu-dra-driver-controller"}
        # Each binary wrote something the run is about.
        assert ("update", "ResourceSlice") in writes["gpu-plugin"] or \
            ("create", "ResourceSlice") in writes["gpu-plugin"]
        assert ("update_status", "ResourceClaim") in writes["gpu-plugin"]
        assert ("update_status", "ResourceClaim") in writes["cd-plugin"]
        assert any(k == "ComputeDomainClique" for _, k in writes["daemon"])
        assert ("create", "DaemonSet") in writes["controller"]
        missing = []
        for binary, seen in writes.items():
            for verb, kind in sorted(seen):
                if kind in SOCKET_STANDINS:
                    continue
                group, resource = KIND_RESOURCES[kind]
                rbac_verb = RBAC_VERBS[verb]
                if verb == "update_status":
                    resource += "/status"
                if not any(group in r["apiGroups"]
                           and resource in r["resources"]
                           and rbac_verb in r["verbs"]
                           for r in roles[role_of[binary]]):
                    missing.append((binary, verb, kind))
        assert not missing, missing


#: The API group and resource of every kind the binaries write.
KIND_RESOURCES = {
    "ResourceSlice": ("resource.k8s.io", "resourceslices"),
    "ResourceClaim": ("resource.k8s.io", "resourceclaims"),
    "ResourceClaimTemplate": ("resource.k8s.io", "resourceclaimtemplates"),
    "DeviceClass": ("resource.k8s.io", "deviceclasses"),
    "Node": ("", "nodes"),
    "Pod": ("", "pods"),
    "Event": ("", "events"),
    "Lease": ("coordination.k8s.io", "leases"),
    "DaemonSet": ("apps", "daemonsets"),
    "ComputeDomain": ("resource.nvidia.com", "computedomains"),
    "ComputeDomainClique": ("resource.nvidia.com", "computedomaincliques"),
}
#: Objects that stand in for the kubelet's plugin-registration socket
#: handshake on the in-memory API (``kubeletplugin/helper.py``): no API
#: write in a cluster, so no RBAC rule.
SOCKET_STANDINS = {"PluginRegistration"}
#: The client's write methods → the RBAC verb each needs.
RBAC_VERBS = {"create": "create", "update": "update",
              "update_status": "update", "delete": "delete",
              "add_finalizer": "update", "remove_finalizer": "update",
              "patch_labels": "patch"}


class _Recorder:
    """A client that records each write's (method, kind) in ``seen`` and
    hands every call to one shared FakeClient."""

    def __init__(self, backing: FakeClient, seen: set):
        self._backing = backing
        self._seen = seen
        self._mu = threading.Lock()

    def __getattr__(self, name):
        attr = getattr(self._backing, name)
        if name not in RBAC_VERBS:
            return attr

        def call(*args, **kwargs):
            first = args[0] if args else kwargs.get("obj") or kwargs.get(
                "kind")
            kind = first["kind"] if isinstance(first, dict) else first
            with self._mu:
                self._seen.add((name, kind))
            return attr(*args, **kwargs)
        return call


def _wait(cond, timeout: float = 20.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _recorded_writes(tmp_path, monkeypatch) -> dict[str, set]:
    """The four binaries in-process on one FakeClient, each through its own
    recording client: the controller (leader-elected) reconciles a
    one-node ComputeDomain, the daemon joins it, the CD plugin prepares a
    channel claim and the GPU plugin a GPU claim, both unprepared after."""
    backing = FakeClient()
    writes: dict[str, set] = {b: set() for b in
                              ("gpu-plugin", "cd-plugin", "daemon",
                               "controller")}
    current = {"binary": ""}
    monkeypatch.setattr(flags, "build_client", lambda args: _Recorder(
        backing, writes[current["binary"]]))
    for d in load_file(CHART / "templates" / "deviceclasses.yaml"):
        backing.create(d)
    backing.create(new_object("Node", "node-0"))
    handles = []

    def start(binary, fn, parser, argv):
        current["binary"] = binary
        handles.append(fn(parser().parse_args(argv), block=False))

    common = ["--node-name", "node-0", "--mock-profile", "h100-8",
              "--metrics-port", "-1", "--healthcheck-addr", "",
              "--node-lease-duration", "1"]
    try:
        start("controller", controller_main.run_controller,
              controller_main.build_parser,
              ["--metrics-port", "-1", "--leader-elect", "--identity", "c0"])
        start("gpu-plugin", plugin_main.run_plugin, plugin_main.build_parser,
              common + ["--state-dir", str(tmp_path / "gs"),
                        "--cdi-root", str(tmp_path / "gc")])
        start("cd-plugin", cd_main.run_plugin, cd_main.build_parser,
              common + ["--state-dir", str(tmp_path / "cs"),
                        "--cdi-root", str(tmp_path / "cc")])
        cd = backing.create(new_compute_domain("dom", num_nodes=1))
        assert _wait(lambda: backing.try_get(
            "ResourceClaimTemplate", "dom-channel", "default"))
        rct = backing.get("ResourceClaimTemplate", "dom-channel", "default")
        alloc = Allocator(backing)
        for name, spec in (("chan", rct["spec"]["spec"]), ("gpu", {
                "devices": {"requests": [{"name": "g", "exactly": {
                    "deviceClassName": "gpu.nvidia.com",
                    "allocationMode": "ExactCount", "count": 1}}]}})):
            backing.create(new_object("ResourceClaim", name, "default",
                                      api_version="resource.k8s.io/v1",
                                      spec=spec))
            alloc.allocate(backing.get("ResourceClaim", name, "default"),
                           reserved_for=[{"resource": "pods", "name": "p"}],
                           node="node-0")
        start("daemon", daemon_main.run_daemon, daemon_main.build_parser,
              ["run", "--node-name", "node-0", "--mock-profile", "h100-8",
               "--cd-uid", cd["metadata"]["uid"], "--cd-name", "dom",
               "--sync-interval", "0.1"])

        def ready(name):
            return bool((backing.get("ResourceClaim", name, "default")
                         .get("status") or {}).get("devices"))
        assert _wait(lambda: ready("chan") and ready("gpu")), \
            "claims never Ready"
        for name in ("chan", "gpu"):
            c = backing.get("ResourceClaim", name, "default")
            c["status"].pop("reservedFor", None)
            backing.update_status(c)
        assert _wait(lambda: not ready("chan") and not ready("gpu"))
    finally:
        for h in reversed(handles):
            h.stop()
    return writes


class TestContainerImage:
    def test_dockerfile_builds_the_port(self):
        text = (REPO / "deployments" / "container" / "Dockerfile.gpu"
                ).read_text()
        copies = [ln for ln in text.splitlines() if ln.startswith("COPY ")]
        assert copies and all(" k8s_dra_driver_tpu_torch/" in ln
                              for ln in copies), copies
        assert "csrc/" in text   # the kernels' sources ship in the package
        assert "ENV PYTHONPATH=" in text
        assert text.rstrip().endswith(
            'CMD ["k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin"]')
        # Every chart command runs from this image's entrypoint.
        assert 'ENTRYPOINT ["python", "-m"]' in text
        assert "pyyaml" not in text.lower()


class TestDemoSpecs:
    @pytest.mark.parametrize("name", GPU_SPECS)
    def test_spec_parses(self, name):
        path = SPECS / f"{name}.yaml"
        docs = [d for d in yaml.safe_load_all(path.read_text()) if d]
        kinds = [d["kind"] for d in docs]
        assert "Namespace" in kinds
        ns = next(d for d in docs if d["kind"] == "Namespace")
        assert ns["metadata"]["name"] == name
        assert all(d["metadata"].get("namespace", name) == name
                   for d in docs)
        templates = {d["metadata"]["name"] for d in docs
                     if d["kind"] == "ResourceClaimTemplate"}
        claims = {d["metadata"]["name"] for d in docs
                  if d["kind"] == "ResourceClaim"}
        cd_templates = {
            d["spec"]["channel"]["resourceClaimTemplate"]["name"]
            for d in docs if d["kind"] == "ComputeDomain"}
        for d in docs:
            if d["kind"] != "Pod":
                continue
            refs = {c["name"] for ctr in d["spec"]["containers"]
                    for c in (ctr.get("resources") or {}).get("claims", [])}
            assert refs == {rc["name"] for rc in
                            d["spec"].get("resourceClaims", [])}, name
            for rc in d["spec"].get("resourceClaims", []):
                if "resourceClaimTemplateName" in rc:
                    assert rc["resourceClaimTemplateName"] in (
                        templates | cd_templates), (name, rc)
                else:
                    assert rc["resourceClaimName"] in claims, (name, rc)

    @pytest.mark.parametrize("name", GPU_SPECS)
    def test_specs_use_the_ports_classes_and_configs(self, name):
        """Device classes are the chart's; opaque configs name the port's
        drivers and kinds, and pass the port's webhook."""
        from k8s_dra_driver_tpu_torch.plugins.webhook.admission import (
            admit_resource_claim_parameters,
        )
        classes = {d["metadata"]["name"]
                   for d in rendered_docs("deviceclasses.yaml")}
        for d in load_file(SPECS / f"{name}.yaml"):
            spec = d.get("spec") or {}
            devices = (spec.get("spec") or spec).get("devices")
            if d["kind"] not in ("ResourceClaim", "ResourceClaimTemplate"):
                continue
            for r in devices["requests"]:
                assert r["exactly"]["deviceClassName"] in classes, r
            resource = ("resourceclaims" if d["kind"] == "ResourceClaim"
                        else "resourceclaimtemplates")
            review = {"apiVersion": "admission.k8s.io/v1",
                      "kind": "AdmissionReview",
                      "request": {"uid": "u", "operation": "CREATE",
                                  "resource": {"group": "resource.k8s.io",
                                               "version": "v1",
                                               "resource": resource},
                                  "object": d}}
            out = admit_resource_claim_parameters(review)
            assert out["allowed"], out


class TestManifestLoader:
    """``pkg/manifests.py`` against PyYAML on every file the port reads
    and on the TPU specs it mirrors."""

    FILES = ([f"demo/specs/quickstart-gpu/{n}.yaml" for n in GPU_SPECS]
             + [f"demo/specs/quickstart/tpu-test{i}.yaml"
                for i in range(1, 8)]
             + ["deployments/helm/gpu-dra-driver/templates/deviceclasses.yaml",
                "deployments/helm/gpu-dra-driver/values.yaml",
                "deployments/helm/tpu-dra-driver/templates/deviceclasses.yaml"])

    @pytest.mark.parametrize("path", FILES)
    def test_reads_like_pyyaml(self, path):
        text = (REPO / path).read_text()
        want = [d for d in yaml.safe_load_all(text) if d]
        assert [d for d in load_all(text) if d] == want

    @pytest.mark.parametrize("text", [
        "a: 1\nb: -2\nc: 1.5\nd: true\ne: off\nf: ~\ng: 0.1.0\nh: 1e-3\n",
        "k: \"x: y # z\"  # c\nm: [a, \"b, c\", 1, [d]]\nn: \"q\\\"s\"\n",
        "s:\n- a\n- b: 1\n  c: [x]\nt:\n  - 1\nu: []\n",
        "---\n# only a comment\n---\nx: 1\n...\n",
    ])
    def test_scalars_and_collections(self, text):
        assert [d for d in load_all(text) if d] == \
            [d for d in yaml.safe_load_all(text) if d]

    @pytest.mark.parametrize("text", [
        "a: |\n  x\n", "a: >-\n  x\n", "a: &anchor 1\n", "a: !!str 1\n",
        "a:\n  b: 1\n   c: 2\n", "a: \"open\n", "a: 1\na: 2\n",
        "a: {}\n", "a: 'single'\n",
    ])
    def test_refuses_what_it_does_not_read(self, text):
        with pytest.raises(ManifestError):
            load_all(text)
