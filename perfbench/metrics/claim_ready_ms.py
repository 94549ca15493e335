"""claim_ready_ms (ms), claim path: host clock from the ResourceClaim's
create to its Ready condition, in set-up."""


def read(run):
    return run.claim_ready_ms
