"""Validating admission webhook (``cmd/webhook`` analogue): the admit
function (``admission``) and its HTTP(S) server (``main``)."""

from k8s_dra_driver_tpu_torch.plugins.webhook.admission import (
    admit_resource_claim_parameters,
    review_response,
)

__all__ = ["admit_resource_claim_parameters", "review_response"]
