"""AdmissionReview validation of opaque device configs.

Copied from the JAX package's ``plugins/webhook/admission.py`` under the
port's driver names: the analogue of ``cmd/webhook/main.go:114-302`` +
``resource.go:33-120``. The webhook accepts ResourceClaims and
ResourceClaimTemplates at ``resource.k8s.io`` v1 / v1beta1 / v1beta2,
converts them to the v1 shape, then strict-decodes every opaque config
addressed to either of this driver's names (``gpu.nvidia.com`` and
``compute-domain.nvidia.com`` — both route through the same config
registry) so users fail fast at admission instead of at node prepare. The
HTTP server around it waits with the webhook's ``main.py``. Unknown fields, unknown kinds, and
``validate()`` failures all deny with the offending field path.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

from k8s_dra_driver_tpu_torch.api.configs import ConfigError, strict_decode

GPU_DRIVER_NAME = "gpu.nvidia.com"
CD_DRIVER_NAME = "compute-domain.nvidia.com"
DRIVER_NAMES = (GPU_DRIVER_NAME, CD_DRIVER_NAME)

RESOURCE_GROUP = "resource.k8s.io"
SUPPORTED_VERSIONS = ("v1", "v1beta1", "v1beta2")
CLAIM_RESOURCE = "resourceclaims"
TEMPLATE_RESOURCE = "resourceclaimtemplates"

REASON_BAD_REQUEST = "BadRequest"
REASON_INVALID = "Invalid"


def _deny(message: str, reason: str) -> dict[str, Any]:
    return {"allowed": False,
            "status": {"message": message, "reason": reason}}


def _allow() -> dict[str, Any]:
    return {"allowed": True}


def convert_claim_spec_to_v1(spec: Mapping[str, Any],
                             version: str) -> dict[str, Any]:
    """Normalize a ResourceClaimSpec across API versions to the v1 shape
    (``resource.go:33-120``'s scheme.Convert analogue).

    The material difference between the DRA versions this webhook accepts
    is the request shape: v1beta1 carries the device request fields inline
    on each entry of ``devices.requests``; v1beta2/v1 nest them under
    ``exactly`` (with ``firstAvailable`` for alternatives). The opaque
    config location (``devices.config[].opaque``) is identical everywhere.
    """
    if version not in SUPPORTED_VERSIONS:
        raise ValueError(f"unsupported resource version: {version}")
    spec = dict(spec)
    devices = dict(spec.get("devices") or {})
    if version == "v1beta1":
        converted = []
        for req in devices.get("requests") or []:
            req = dict(req)
            if "firstAvailable" in req or "exactly" in req:
                converted.append(req)
                continue
            inline = {k: v for k, v in req.items() if k != "name"}
            converted.append({"name": req.get("name", ""), "exactly": inline})
        devices["requests"] = converted
    spec["devices"] = devices
    return spec


def _extract_configs(review: Mapping[str, Any]
                     ) -> tuple[Optional[list], str, Optional[dict]]:
    """Pull the device-config list + its field-path prefix out of the
    request object, or return a denial (main.go:200-245)."""
    request = review.get("request")
    if not isinstance(request, Mapping):
        return None, "", _deny("review carries no request", REASON_BAD_REQUEST)
    resource = request.get("resource")
    if not isinstance(resource, Mapping):
        resource = {}
    group = resource.get("group", "")
    version = resource.get("version", "")
    res = resource.get("resource", "")
    obj = request.get("object")
    if not isinstance(obj, Mapping):
        return None, "", _deny("request carries no object", REASON_BAD_REQUEST)

    if group != RESOURCE_GROUP or version not in SUPPORTED_VERSIONS or \
            res not in (CLAIM_RESOURCE, TEMPLATE_RESOURCE):
        return None, "", _deny(
            f"expected resource to be one of the supported versions for "
            f"resourceclaims or resourceclaimtemplates, got "
            f"{group}/{version} {res!r}", REASON_BAD_REQUEST)

    try:
        if res == CLAIM_RESOURCE:
            spec = convert_claim_spec_to_v1(obj.get("spec") or {}, version)
            spec_path = "spec"
        else:
            inner = (obj.get("spec") or {}).get("spec") or {}
            spec = convert_claim_spec_to_v1(inner, version)
            spec_path = "spec.spec"
    except (ValueError, TypeError, AttributeError) as e:
        return None, "", _deny(
            f"failed to read {res} from request: {e}", REASON_BAD_REQUEST)

    configs = (spec.get("devices") or {}).get("config") or []
    if not isinstance(configs, list):
        return None, "", _deny(
            f"{spec_path}.devices.config must be a list", REASON_BAD_REQUEST)
    return configs, spec_path, None


def admit_resource_claim_parameters(
        review: Mapping[str, Any]) -> dict[str, Any]:
    """The admit function (``admitResourceClaimParameters``,
    main.go:200-302): returns an AdmissionResponse dict."""
    configs, spec_path, denial = _extract_configs(review)
    if denial is not None:
        return denial

    errs: list[str] = []
    for i, config in enumerate(configs):
        if not isinstance(config, Mapping):
            errs.append(f"object at {spec_path}.devices.config[{i}] "
                        "must be an object")
            continue
        opaque = config.get("opaque")
        if not isinstance(opaque, Mapping) or \
                opaque.get("driver") not in DRIVER_NAMES:
            continue
        field_path = f"{spec_path}.devices.config[{i}].opaque.parameters"
        params = opaque.get("parameters")
        if not isinstance(params, Mapping):
            errs.append(f"error decoding object at {field_path}: "
                        "parameters must be an object")
            continue
        try:
            strict_decode(params)
        except ConfigError as e:
            errs.append(f"object at {field_path} is invalid: {e}")
        except (ValueError, TypeError) as e:
            # Opaque parameters are not schema-checked by the apiserver, so
            # a field can hold any JSON shape (env: "abc"); decode errors
            # must deny with the field path, not crash the request.
            errs.append(f"error decoding object at {field_path}: {e}")

    if errs:
        return _deny(f"{len(errs)} configs failed to validate: "
                     + "; ".join(errs), REASON_INVALID)
    return _allow()


def review_response(review: Mapping[str, Any]) -> dict[str, Any]:
    """Wrap the admit function's response in a full AdmissionReview,
    echoing the request UID (main.go:160-164)."""
    if not isinstance(review, Mapping):
        raise ValueError(
            f"request body must be an AdmissionReview object, "
            f"got {type(review).__name__}")
    if review.get("kind") != "AdmissionReview" or \
            not str(review.get("apiVersion", "")).startswith("admission.k8s.io/"):
        raise ValueError(
            f"unsupported group version kind: "
            f"{review.get('apiVersion')}/{review.get('kind')}")
    response = admit_resource_claim_parameters(review)
    response["uid"] = (review.get("request") or {}).get("uid", "")
    return {"apiVersion": review.get("apiVersion"),
            "kind": "AdmissionReview",
            "response": response}
