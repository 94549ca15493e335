"""The traffic generator: deterministic for a seed, true to its parameters,
the same work in another order for another seed."""

import itertools
import json
import os
from collections import Counter

import numpy as np
import pytest

from perfbench import generate

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mix(name):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


#: An open-loop mix for the generator's tests (no cell runs one yet): the
#: parameters last measured for an open loop on the card, 34 requests a
#: second with prompts of median 4,096.
POISSON = {"kind": "poisson", "rate_per_s": 34.0, "tenants": 4,
           "prompt": {"dist": "lognormal", "median": 4096, "sigma": 0.8,
                      "min": 1024, "max": 15872},
           "output": {"dist": "lognormal", "median": 128, "sigma": 0.7,
                      "min": 32, "max": 512},
           "block": 256}
MIXES = {"longdoc-backlog": lambda: mix("longdoc-backlog"),
         "poisson": lambda: dict(POISSON)}


def take(m, seed, n):
    return list(itertools.islice(generate.stream(m, seed), n))


@pytest.mark.parametrize("name", list(MIXES))
def test_a_seed_gives_the_same_requests(name):
    assert take(MIXES[name](), 3_000_000_019, 600) == \
        take(MIXES[name](), 3_000_000_019, 600)


@pytest.mark.parametrize("name", list(MIXES))
def test_seeds_reorder_the_same_sizes(name):
    m = MIXES[name]()
    block = m["block"]
    a, b = take(m, 1, 2 * block), take(m, 2**31 + 5, 2 * block)
    assert [r.prompt_tokens for r in a] != [r.prompt_tokens for r in b]
    for i in range(2):
        sl = slice(i * block, (i + 1) * block)
        for key in ("prompt_tokens", "max_new_tokens"):
            assert Counter(getattr(r, key) for r in a[sl]) == \
                Counter(getattr(r, key) for r in b[sl])


def test_the_long_document_mix_keeps_its_sources_means():
    # GovReport's 9,409.4-word documents and 553.4-word summaries at 4/3
    # tokens a word; every request fits the configuration's context.
    m = mix("longdoc-backlog")
    prompts = generate.quantiles(m["prompt"], m["block"])
    outputs = generate.quantiles(m["output"], m["block"])
    assert abs(prompts.mean() - 9409.4 * 4 / 3) < 5
    assert abs(outputs.mean() - 553.4 * 4 / 3) < 1
    with open(os.path.join(HERE, "configs", "ouro-2.6b-attn.json")) as f:
        cap = json.load(f)["engine"]["kv_cap"]
    assert prompts.max() + outputs.max() <= cap


def test_lognormal_quantiles_follow_median_sigma_and_clip():
    spec = {"dist": "lognormal", "median": 4096, "sigma": 0.8,
            "min": 1024, "max": 15872}
    q = generate.quantiles(spec, 256)
    assert q.min() == 1024 and q.max() == 15872
    assert abs(np.median(q) - 4096) <= 40
    # The unclipped middle follows exp(sigma z): the quartiles are
    # median * exp(-+0.8 * 0.6745).
    assert abs(np.percentile(q, 75) / 4096 - np.exp(0.8 * 0.6745)) < 0.03
    assert abs(np.percentile(q, 25) / 4096 - np.exp(-0.8 * 0.6745)) < 0.03


def test_uniform_lengths():
    q = generate.quantiles({"dist": "uniform", "min": 128, "max": 384}, 257)
    assert q.min() == 128 and q.max() == 384
    assert abs(q.mean() - 256) < 1
    with pytest.raises(ValueError):
        generate.quantiles({"dist": "fixed", "value": 7}, 5)


def test_backlog_has_no_due_times_and_tenants_take_turns():
    reqs = take(mix("longdoc-backlog"), 5, 12)
    assert all(r.due_s is None for r in reqs)
    names = generate.tenant_names(4)
    assert [r.tenant for r in reqs] == names * 3
    assert len({generate.tenant_bucket(t) for t in names}) == 4


def test_poisson_arrivals_run_at_the_rate():
    m = dict(POISSON)
    rate = m["rate_per_s"]
    arr = generate.arrivals(m, 9, 20.0)
    assert abs(len(arr) / (rate * 20.0) - 1) < 0.02
    dues = [r.due_s for r in arr]
    assert dues == sorted(dues) and dues[-1] < 20.0
    gaps = np.diff(dues)
    # Exponential gaps: as many above the mean as e^-1 of them.
    assert abs((gaps > 1 / rate).mean() - np.exp(-1)) < 0.05


def test_warmup_is_one_block_of_the_mix_sizes():
    m = dict(POISSON)
    a, b = generate.warmup(m, 1, 64), generate.warmup(m, 2, 64)
    assert len(a) == 64
    assert sorted(r.prompt_tokens for r in a) == \
        sorted(r.prompt_tokens for r in b)
    assert sorted(r.prompt_tokens for r in a) == \
        list(generate.quantiles(m["prompt"], 64))


@pytest.mark.parametrize("bad", [
    {"kind": "closed"},
    {"kind": "backlog", "queued_min": 0},
    {"kind": "poisson", "rate_per_s": 0},
])
def test_a_mix_the_generator_cannot_run_is_refused(bad):
    m = dict(POISSON)
    m.pop("rate_per_s")
    m.update(bad)
    with pytest.raises((ValueError, KeyError)):
        generate.check_mix(m)


def test_tenant_names_are_in_distinct_buckets():
    names = generate.tenant_names(16)
    assert len({generate.tenant_bucket(t) for t in names}) == 16
    assert generate.tenant_value("tenant-a") == \
        1.0 + 0.5 * generate.tenant_bucket("tenant-a")
