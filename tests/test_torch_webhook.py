"""The port's admission webhook, held against the JAX package's.

A corpus of AdmissionReviews (ResourceClaims and templates at v1, v1beta1
and v1beta2, with opaque configs for either driver of each package) goes
through both packages' ``admit_resource_claim_parameters``: the decision,
the reason and the message agree once the JAX package's names (API group,
driver names, the full-device config kind and its driver-managed variable)
are mapped to the port's. Then the scenarios of ``tests/test_webhook.py``
that need no HTTP server, on the port, and the MIG and VFIO config kinds
against their JAX counterparts.
"""

import re

import pytest

from k8s_dra_driver_tpu.plugins.webhook import admission as jax_admission
from k8s_dra_driver_tpu_torch.plugins.webhook.admission import (
    CD_DRIVER_NAME,
    GPU_DRIVER_NAME,
    admit_resource_claim_parameters,
    convert_claim_spec_to_v1,
    review_response,
)

API = "resource.nvidia.com/v1beta1"
DOMAIN_ID = "0f0f0f0f-0000-4000-8000-000000000001"

# Each package's names for the same things.
PORT = {"api": API, "kind": "GpuConfig", "driver": GPU_DRIVER_NAME,
        "cd": CD_DRIVER_NAME, "managed": "CUDA_VISIBLE_DEVICES",
        "admit": admit_resource_claim_parameters}
JAX = {"api": "resource.tpu.google.com/v1beta1", "kind": "TpuConfig",
       "driver": jax_admission.TPU_DRIVER_NAME,
       "cd": jax_admission.CD_DRIVER_NAME, "managed": "TPU_VISIBLE_CHIPS",
       "admit": jax_admission.admit_resource_claim_parameters}


def _review(resource, obj, uid="uid-1", version="v1"):
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "request": {
            "uid": uid,
            "resource": {"group": "resource.k8s.io", "version": version,
                         "resource": resource},
            "object": obj,
        },
    }


def _claim(configs, version="v1"):
    spec = {"devices": {
        "requests": [{"name": "gpu",
                      "exactly": {"deviceClassName": GPU_DRIVER_NAME}}],
        "config": configs,
    }}
    return _review("resourceclaims", {"spec": spec}, version=version)


def _template(configs, version="v1"):
    spec = {"devices": {"requests": [], "config": configs}}
    return _review("resourceclaimtemplates", {"spec": {"spec": spec}},
                   version=version)


def _opaque(params, driver=GPU_DRIVER_NAME):
    return {"opaque": {"driver": driver, "parameters": params}}


def _device(n, **extra):
    return _opaque({"apiVersion": n["api"], "kind": n["kind"], **extra},
                   n["driver"])


def _channel(n, **fields):
    return _opaque({"apiVersion": n["api"],
                    "kind": "ComputeDomainChannelConfig", **fields}, n["cd"])


def _daemon(n, **fields):
    return _opaque({"apiVersion": n["api"],
                    "kind": "ComputeDomainDaemonConfig", **fields}, n["cd"])


# The corpus: name → a function of one package's names giving a review.
CORPUS = {
    "no-configs": lambda n: _claim([]),
    "device-env": lambda n: _claim([_device(n, env={"FOO": "1"})]),
    "device-unknown-field": lambda n: _claim([_device(n, bogusField=1)]),
    "device-managed-env": lambda n: _claim([_device(
        n, env={n["managed"]: "0"})]),
    "channel-single": lambda n: _claim([_channel(
        n, domainID=DOMAIN_ID, allocationMode="Single")]),
    "channel-all": lambda n: _claim([_channel(
        n, domainID=DOMAIN_ID, allocationMode="All")]),
    "channel-default-mode": lambda n: _claim([_channel(n,
                                                       domainID=DOMAIN_ID)]),
    "channel-bad-mode": lambda n: _claim([_channel(
        n, domainID=DOMAIN_ID, allocationMode="Some")]),
    "channel-no-domain": lambda n: _claim([_channel(n)]),
    "channel-upper-case-uuid": lambda n: _claim([_channel(
        n, domainID=DOMAIN_ID.upper())]),
    "daemon-valid": lambda n: _claim([_daemon(n, domainID=DOMAIN_ID)]),
    "daemon-bad-domain": lambda n: _claim([_daemon(n,
                                                   domainID="not-a-uuid")]),
    "daemon-extra-field": lambda n: _claim([_daemon(
        n, domainID=DOMAIN_ID, allocationMode="All")]),
    "unknown-kind": lambda n: _claim([_opaque(
        {"apiVersion": n["api"], "kind": "NopeConfig"}, n["driver"])]),
    "bad-api-version": lambda n: _claim([_opaque(
        {"apiVersion": "other/v9", "kind": n["kind"]}, n["driver"])]),
    "no-api-version": lambda n: _claim([_opaque({"kind": n["kind"]},
                                                n["cd"])]),
    "non-object-parameters": lambda n: _claim([_opaque([1, 2, 3],
                                                       n["driver"])]),
    "non-object-config-entry": lambda n: _claim(["bogus"]),
    "foreign-driver": lambda n: _claim([_opaque({"whatever": True},
                                                "other.example.com")]),
    "several-errors": lambda n: _claim([
        _device(n, x=1), _device(n), _channel(n, domainID="x"),
        _opaque({"apiVersion": n["api"], "kind": "NopeConfig"}, n["cd"])]),
    "template": lambda n: _template([_device(n, junk=1),
                                     _channel(n, domainID=DOMAIN_ID)]),
    "v1beta1": lambda n: _claim([_device(n, zz=1)], "v1beta1"),
    "v1beta2": lambda n: _claim([_daemon(n, domainID=DOMAIN_ID)],
                                "v1beta2"),
    "unsupported-version": lambda n: _claim([], "v1alpha3"),
    "unsupported-resource": lambda n: _review("pods", {"spec": {}}),
    "missing-object": lambda n: _review("resourceclaims", None),
}


def _as_port(text: str) -> str:
    """A JAX message in the port's names; the list of known kinds, which
    differs by package, cut out."""
    for old, new in (("resource.tpu.google.com", "resource.nvidia.com"),
                     ("compute-domain.tpu.google.com", CD_DRIVER_NAME),
                     ("tpu.google.com", GPU_DRIVER_NAME),
                     ("TpuConfig", "GpuConfig"),
                     ("TPU_VISIBLE_CHIPS", "CUDA_VISIBLE_DEVICES")):
        text = text.replace(old, new)
    return re.sub(r"; known: \[[^]]*\]", "", text)


@pytest.mark.parametrize("case", sorted(CORPUS))
def test_admission_matches_jax(case):
    want = JAX["admit"](CORPUS[case](JAX))
    got = PORT["admit"](CORPUS[case](PORT))
    assert got["allowed"] == want["allowed"]
    if not want["allowed"]:
        assert got["status"]["reason"] == want["status"]["reason"]
        assert _as_port(got["status"]["message"]) == \
            _as_port(want["status"]["message"])


class TestAdmit:
    def test_valid_channel_config_allowed(self):
        assert admit_resource_claim_parameters(
            CORPUS["channel-single"](PORT))["allowed"]

    def test_unknown_field_denied_with_its_path(self):
        resp = admit_resource_claim_parameters(
            CORPUS["device-unknown-field"](PORT))
        assert not resp["allowed"]
        assert "spec.devices.config[0].opaque.parameters" in \
            resp["status"]["message"]
        assert resp["status"]["reason"] == "Invalid"

    def test_wrong_shaped_field_value_denied_not_crashed(self):
        # Opaque params are not schema-checked by the apiserver: a field
        # holding the wrong JSON shape must deny with the field path.
        resp = admit_resource_claim_parameters(_claim([_device(
            PORT, env="abc")]))
        assert not resp["allowed"]
        assert "config[0]" in resp["status"]["message"]

    def test_multiple_errors_aggregated(self):
        resp = admit_resource_claim_parameters(CORPUS["several-errors"](PORT))
        assert resp["status"]["message"].startswith("3 configs failed")
        for i in (0, 2, 3):
            assert f"config[{i}]" in resp["status"]["message"]

    def test_template_path_prefix(self):
        resp = admit_resource_claim_parameters(CORPUS["template"](PORT))
        assert "spec.spec.devices.config[0]" in resp["status"]["message"]

    @pytest.mark.parametrize("kind,feature", [
        ("MigDeviceConfig", "MIG partitions"),
        ("VfioDeviceConfig", "VFIO passthrough")])
    def test_kinds_of_features_still_to_come_denied(self, kind, feature):
        """The kinds once refused for want of their feature are admitted
        when valid and denied on a bad value or an unknown field, as the
        JAX webhook admits and denies its counterparts (SubsliceConfig,
        VfioChipConfig) on the same shapes."""
        port_jax = {
            "MigDeviceConfig": ("SubsliceConfig", {"profile": "3g.40gb"},
                                {"shape": "2x2"}, {"profile": "9g.90gb"},
                                {"shape": "2by2"}),
            "VfioDeviceConfig": ("VfioChipConfig", {"iommu": "iommufd"},
                                 {"iommu": "iommufd"}, {"iommu": "nope"},
                                 {"iommu": "nope"})}
        jax_kind, good, jax_good, bad, jax_bad = port_jax[kind]
        for fields, jax_fields, allowed in ((good, jax_good, True),
                                            (bad, jax_bad, False),
                                            ({"zz": 1}, {"zz": 1}, False)):
            resp = admit_resource_claim_parameters(_claim([_opaque(
                {"apiVersion": API, "kind": kind, **fields})]))
            theirs = JAX["admit"](_claim([_opaque(
                {"apiVersion": JAX["api"], "kind": jax_kind, **jax_fields},
                JAX["driver"])]))
            assert resp["allowed"] is theirs["allowed"] is allowed, \
                (feature, fields, resp)
            if not allowed:
                assert kind in resp["status"]["message"]
                assert "config[0]" in resp["status"]["message"]

    def test_both_drivers_are_validated_and_no_other(self):
        bad = {"apiVersion": API, "kind": "GpuConfig", "zz": 1}
        for driver, allowed in ((GPU_DRIVER_NAME, False),
                                (CD_DRIVER_NAME, False),
                                ("gpu.example.com", True)):
            resp = admit_resource_claim_parameters(_claim([_opaque(
                bad, driver)]))
            assert resp["allowed"] is allowed, driver


class TestVersionConversion:
    def test_v1beta1_inline_requests_converted(self):
        spec = {"devices": {"requests": [
            {"name": "gpu", "deviceClassName": GPU_DRIVER_NAME, "count": 2,
             "allocationMode": "ExactCount"}]}}
        v1 = convert_claim_spec_to_v1(spec, "v1beta1")
        req = v1["devices"]["requests"][0]
        assert req["name"] == "gpu"
        assert req["exactly"]["deviceClassName"] == GPU_DRIVER_NAME
        assert req["exactly"]["count"] == 2
        assert v1 == jax_admission.convert_claim_spec_to_v1(spec, "v1beta1")

    def test_v1beta2_passthrough(self):
        spec = {"devices": {"requests": [
            {"name": "gpu", "exactly": {"deviceClassName": "x"}}]}}
        assert convert_claim_spec_to_v1(spec, "v1beta2") == spec

    def test_all_versions_validate_configs(self):
        bad = _device(PORT, zz=1)
        for version in ("v1", "v1beta1", "v1beta2"):
            resp = admit_resource_claim_parameters(_claim([bad], version))
            assert not resp["allowed"], version

    def test_v1beta1_first_available_preserved(self):
        spec = {"devices": {"requests": [
            {"name": "gpu", "firstAvailable": [
                {"name": "a", "deviceClassName": "x"}]}]}}
        v1 = convert_claim_spec_to_v1(spec, "v1beta1")
        assert "firstAvailable" in v1["devices"]["requests"][0]

    def test_unknown_version_raises(self):
        with pytest.raises(ValueError, match="unsupported resource version"):
            convert_claim_spec_to_v1({}, "v2")


class TestReviewEnvelope:
    def test_uid_echoed(self):
        out = review_response(_claim([]))
        assert out["kind"] == "AdmissionReview"
        assert out["response"]["uid"] == "uid-1"
        assert out["response"]["allowed"]
        assert out == jax_admission.review_response(_claim([]))

    @pytest.mark.parametrize("body", [
        {"apiVersion": "v1", "kind": "Pod"},
        {"apiVersion": "other/v1", "kind": "AdmissionReview"},
        ["not", "an", "object"]])
    def test_wrong_envelope_raises(self, body):
        with pytest.raises(ValueError):
            review_response(body)
        with pytest.raises(ValueError):
            jax_admission.review_response(body)
