"""The GPU port's serving engine held against the JAX package's.

Every engine invariant of ``tests/test_serving.py`` re-run on the port's
engine on the CPU (the token budget, chunked prefill, the mixed-tenant
isolation oracle, bounded-queue rejections, drain, the outcome counters
in the exposition); then parity: one seeded request stream through both
engines, driven by ``step()``, must give identical step logs and outcome
counts and decoded rows within 1e-5. Plus the claim binding:
``parse_visible_devices`` on ``CUDA_VISIBLE_DEVICES`` and ``bind_engine``.
"""

import re
import time

import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.compute import serving as jax_serving
from k8s_dra_driver_tpu_torch.compute import serving as port_serving
from k8s_dra_driver_tpu_torch.compute.flashattention import (
    flash_attention_decode,
)
from k8s_dra_driver_tpu_torch.compute.serving import (
    DecodeRequest,
    ServingEngine,
    ServingMetrics,
    bind_engine,
    kv_state_from_numpy,
    parse_visible_devices,
    tenant_vector,
)


def _engine(**kw):
    """A deterministic CPU engine: driven by step(), never started, with a
    modeled rate high enough that drain deadlines are irrelevant."""
    args = dict(n_chips=2, metrics=ServingMetrics(), max_batch=4,
                kv_cap=32, tokens_per_chip_step=8,
                modeled_chip_tok_s=1e9, queue_cap=64, device="cpu")
    args.update(kw)
    return ServingEngine("test", **args)


def _req(i, tenant, prompt=6, new=4, cls=DecodeRequest):
    return cls(rid=f"r{i}", tenant=tenant, prompt_tokens=prompt,
               max_new_tokens=new)


def _run_to_completion(eng, max_steps=500):
    for _ in range(max_steps):
        if eng.completed + eng.shed + eng.rejected >= eng.submitted \
                and eng.queue_depth() == 0 and not eng._active:
            return
        eng.step()
    raise AssertionError(
        f"engine did not converge in {max_steps} steps: "
        f"submitted={eng.submitted} completed={eng.completed}")


# --------------------------------------------------------------------------
# property: a step never exceeds the per-step token budget
# --------------------------------------------------------------------------

class TestTokenBudget:
    def test_every_step_within_budget(self):
        eng = _engine()
        reqs = [_req(i, f"tenant-{i % 3}", prompt=5 + 3 * (i % 4),
                     new=2 + i % 5) for i in range(16)]
        for r in reqs:
            assert eng.submit(r)
        _run_to_completion(eng)
        assert eng.step_log, "no steps recorded"
        for entry in eng.step_log:
            assert entry["tokens"] <= entry["budget"], entry
            assert entry["budget"] == eng.step_budget

    def test_budget_scales_with_chips(self):
        assert _engine(n_chips=1).step_budget == 8
        assert _engine(n_chips=4).step_budget == 32

    def test_oversized_prompt_is_chunked_not_burst(self):
        eng = _engine(kv_cap=64)
        assert eng.submit(_req(0, "tenant-a", prompt=50, new=1))
        _run_to_completion(eng)
        assert max(e["tokens"] for e in eng.step_log) <= eng.step_budget
        assert eng.prefill_tokens == 50


# --------------------------------------------------------------------------
# property: a batch never mixes tenants' KV state
# --------------------------------------------------------------------------

class TestTenantKvIsolation:
    def test_mixed_tenant_batch_decodes_each_tenants_constant(self):
        eng = _engine(max_batch=6)
        tenants = ["tenant-a", "tenant-b", "tenant-c"]
        reqs = [_req(i, tenants[i % 3], prompt=4 + i % 5, new=3)
                for i in range(18)]
        for r in reqs:
            assert eng.submit(r)
        _run_to_completion(eng)
        assert eng.completed == len(reqs)
        assert eng.kv_isolation_max_err < 1e-4
        for r in reqs:
            vec = tenant_vector(r.tenant, eng.head_dim)
            assert isinstance(r.last_output, np.ndarray)
            assert r.last_output.shape == (eng.heads, eng.head_dim)
            assert float(np.max(np.abs(r.last_output - vec[None, :]))) \
                < 1e-4

    def test_tenant_vectors_are_spaced_and_match_jax(self):
        va = tenant_vector("tenant-a", 8)
        vb = tenant_vector("tenant-b", 8)
        assert np.all(va == va[0]) and np.all(vb == vb[0])
        if va[0] != vb[0]:
            assert abs(float(va[0] - vb[0])) >= 0.5
        for t in ("tenant-a", "tenant-b", "x", ""):
            assert np.array_equal(tenant_vector(t, 16),
                                  jax_serving.tenant_vector(t, 16))

    def test_bleed_is_detected(self):
        # The oracle is live: an attend that reads the neighbouring slot's
        # rows must push kv_isolation_max_err past the tolerance.
        def leaky(q, k, v, lens):
            return flash_attention_decode(q, k.roll(1, 0), v.roll(1, 0),
                                          lens.roll(1, 0))
        eng = _engine(attend=leaky)
        for i in range(4):
            eng.submit(_req(i, ["tenant-a", "tenant-b"][i % 2]))
        _run_to_completion(eng)
        assert eng.kv_isolation_max_err >= 0.5


# --------------------------------------------------------------------------
# property: drain loses zero requests uncounted
# --------------------------------------------------------------------------

class TestAccountingIdentity:
    def _identity(self, eng):
        assert eng.completed + eng.shed + eng.rejected == eng.submitted

    def test_bounded_queue_rejects_and_counts(self):
        eng = _engine(queue_cap=4)
        admitted = sum(eng.submit(_req(i, "tenant-a")) for i in range(10))
        assert admitted == 4
        assert eng.rejected == 6
        summary = eng.drain(timeout=0.0)
        assert summary["accounted"]
        assert eng.shed == 4
        self._identity(eng)

    def test_drain_mid_flight_sheds_in_flight(self):
        eng = _engine()
        for i in range(8):
            assert eng.submit(_req(i, "tenant-a", prompt=20, new=50))
        eng.step()
        eng.step()
        summary = eng.drain(timeout=0.0)
        assert summary["accounted"]
        assert eng.shed > 0
        self._identity(eng)
        assert sorted(eng._free) == list(range(eng.max_batch))

    def test_submit_after_drain_is_rejected_and_counted(self):
        eng = _engine()
        eng.drain(timeout=0.0)
        assert not eng.submit(_req(0, "tenant-a"))
        self._identity(eng)

    def test_clean_run_completes_everything(self):
        eng = _engine()
        for i in range(6):
            assert eng.submit(_req(i, f"tenant-{i % 2}"))
        _run_to_completion(eng)
        summary = eng.drain(timeout=0.0)
        assert summary["accounted"]
        assert eng.completed == 6 and eng.shed == 0 and eng.rejected == 0

    def test_outcome_counters_match_engine_totals(self):
        eng = _engine(queue_cap=3)
        for i in range(8):
            eng.submit(_req(i, "tenant-a"))
        _run_to_completion(eng)
        eng.drain(timeout=0.0)
        text = eng.metrics.registry.expose_text()
        assert eng.completed and eng.rejected
        for outcome, n in (("completed", eng.completed),
                           ("rejected", eng.rejected)):
            assert (f'gpu_dra_serving_requests_total'
                    f'{{tenant="tenant-a",outcome="{outcome}"}} '
                    f'{float(n)}') in text

    def test_exposition_matches_the_jax_format(self):
        # Same observations into both packages' ServingMetrics: the same
        # text, family names and HELP strings aside (exemplar timestamps
        # normalised).
        port, ref = ServingMetrics(), jax_serving.ServingMetrics()
        for m in (port, ref):
            m.requests_total.inc(tenant='a "q"\n', outcome="completed")
            m.tokens_total.inc(7, tenant="a", kind="prefill")
            m.queue_depth.set(3, tenant="a")
            m.batch_size.observe(5)
            m.ttft_seconds.observe(0.004, exemplar="trace-1", tenant="a")
            m.request_seconds.observe(99.0, exemplar="trace-2", tenant="a")
            m.first_batch_seconds.observe(0.02, tenant="b")

        def norm(text):
            text = re.sub(r"(?m)^# HELP (\S+) .*$", r"# HELP \1", text)
            return re.sub(r" ts=[0-9.e+-]+", " ts=T", text)
        want = norm(ref.registry.expose_text()).replace("tpu_dra_", "gpu_dra_")
        assert norm(port.registry.expose_text()) == want
        assert "# EXEMPLAR gpu_dra_serving_request_seconds_bucket" in want

    def test_started_engine_serves_and_drains(self):
        eng = _engine().start()
        reqs = [_req(i, f"tenant-{i % 2}") for i in range(6)]
        for r in reqs:
            assert eng.submit(r)
        deadline = time.monotonic() + 30
        while eng.completed < len(reqs) and time.monotonic() < deadline:
            time.sleep(0.005)
        summary = eng.drain(timeout=5.0)
        assert summary["accounted"] and summary["completed"] == len(reqs)
        assert eng._thread is None


# --------------------------------------------------------------------------
# parity: one request stream through the JAX engine and the port's
# --------------------------------------------------------------------------

def _stream(seed, n):
    rng = np.random.default_rng(seed)
    tenants = ["tenant-a", "tenant-b", "tenant-c", "tenant-d"]
    return [(f"r{i}", tenants[int(rng.integers(4))],
             int(rng.integers(1, 30)), int(rng.integers(1, 10)))
            for i in range(n)]


def _drive(engine, request_cls, stream, steps_before_drain):
    reqs = [request_cls(rid=r, tenant=t, prompt_tokens=p, max_new_tokens=n)
            for r, t, p, n in stream]
    admitted = [engine.submit(r) for r in reqs]
    if steps_before_drain is None:
        _run_to_completion(engine)
    else:
        for _ in range(steps_before_drain):
            engine.step()
    summary = engine.drain(timeout=0.0)
    return reqs, admitted, summary


@pytest.mark.parametrize("seed,config,steps_before_drain", [
    (0, dict(max_batch=4, kv_cap=32, tokens_per_chip_step=8), None),
    (1, dict(max_batch=6, kv_cap=40, tokens_per_chip_step=5, heads=3,
             head_dim=16), None),
    (2, dict(max_batch=3, kv_cap=16, tokens_per_chip_step=4,
             queue_cap=10), 12),
])
def test_parity_with_jax_engine(seed, config, steps_before_drain):
    kw = dict(n_chips=2, modeled_chip_tok_s=1e9, queue_cap=64)
    kw.update(config)
    stream = _stream(seed, 24)
    jax_eng = jax_serving.ServingEngine(
        "parity", metrics=jax_serving.ServingMetrics(), **kw)
    port = ServingEngine("parity", metrics=ServingMetrics(), device="cpu",
                         **kw)
    jax_reqs, jax_adm, jax_sum = _drive(
        jax_eng, jax_serving.DecodeRequest, stream, steps_before_drain)
    port_reqs, port_adm, port_sum = _drive(
        port, DecodeRequest, stream, steps_before_drain)
    assert port_adm == jax_adm
    assert port_sum == jax_sum
    assert list(port.step_log) == list(jax_eng.step_log)
    assert port.steps == jax_eng.steps > 0
    if steps_before_drain is not None:
        assert port.shed > 0 and port.rejected > 0
    assert port.kv_isolation_max_err < 1e-4
    for a, b in zip(port_reqs, jax_reqs):
        assert (a.outcome, a.generated, a.kv_len, a.phase) == \
            (b.outcome, b.generated, b.kv_len, b.phase)
        if b.last_output is None:
            assert a.last_output is None
        else:
            assert float(np.max(np.abs(a.last_output - b.last_output))) \
                < 1e-5


def test_kv_state_carries_a_mid_run_jax_slab():
    kw = dict(n_chips=1, max_batch=4, kv_cap=32, heads=2, head_dim=8,
              tokens_per_chip_step=6, modeled_chip_tok_s=1e9)
    jax_eng = jax_serving.ServingEngine(
        "src", metrics=jax_serving.ServingMetrics(), **kw)
    for r, t, p, n in _stream(5, 8):
        jax_eng.submit(jax_serving.DecodeRequest(
            rid=r, tenant=t, prompt_tokens=p, max_new_tokens=n))
    for _ in range(7):
        jax_eng.step()
    assert jax_eng._lens.max() > 0
    port = ServingEngine("dst", metrics=ServingMetrics(), device="cpu", **kw)
    kv_state_from_numpy(port, jax_eng._K, jax_eng._V, jax_eng._lens)
    assert np.array_equal(port._lens.numpy(), jax_eng._lens)
    q = np.random.default_rng(0).standard_normal(
        (4, 2, 1, 8)).astype(np.float32)
    lens = np.maximum(jax_eng._lens, 1)
    want = np.asarray(jax_eng.attend(q, jax_eng._K, jax_eng._V, lens))
    got = port.attend(torch.from_numpy(q), port._K, port._V,
                      torch.clamp(port._lens, min=1)).numpy()
    assert float(np.max(np.abs(got - want))) < 1e-4
    with pytest.raises(ValueError, match="shape"):
        kv_state_from_numpy(port, jax_eng._K[:2], jax_eng._V, jax_eng._lens)


# --------------------------------------------------------------------------
# the claim binding: CUDA_VISIBLE_DEVICES from the CDI spec
# --------------------------------------------------------------------------

class TestParseVisibleDevices:
    def test_missing_and_void(self):
        assert parse_visible_devices(None) == []
        assert parse_visible_devices({}) == []
        assert parse_visible_devices(
            {"containerEdits": {"env": ["CUDA_VISIBLE_DEVICES=void"]}}) == []

    def test_claim_wide_and_per_device_union(self):
        spec = {
            "containerEdits": {"env": ["CUDA_VISIBLE_DEVICES=3,1"]},
            "devices": [
                {"containerEdits": {"env": ["CUDA_VISIBLE_DEVICES=0"]}},
                {"containerEdits": {"env": ["OTHER=x",
                                            "CUDA_VISIBLE_DEVICES=1, 2"]}},
            ],
        }
        assert parse_visible_devices(spec) == [0, 1, 2, 3]

    def test_same_answers_as_the_tpu_parser(self):
        for val in ("0", "3,1", " 2 , 0 ", "", "void"):
            spec = {"containerEdits": {"env": [
                f"CUDA_VISIBLE_DEVICES={val}", "TPU_VISIBLE_CHIPS=7"]}}
            tpu = {"containerEdits": {"env": [f"TPU_VISIBLE_CHIPS={val}"]}}
            assert parse_visible_devices(spec) == \
                jax_serving.parse_visible_chips(tpu)

    def test_uuid_entries_are_refused(self):
        with pytest.raises(ValueError):
            parse_visible_devices({"containerEdits": {"env": [
                "CUDA_VISIBLE_DEVICES=GPU-8f2a6b1c-0000-1111-2222-333344445555"
            ]}})

    def test_engine_refuses_zero_chips(self):
        with pytest.raises(ValueError):
            ServingEngine("empty", n_chips=0, metrics=ServingMetrics(),
                          device="cpu")


class TestBindEngine:
    SPEC = {"containerEdits": {"env": ["CUDA_VISIBLE_DEVICES=2,5",
                                       "NVIDIA_VISIBLE_DEVICES=2,5"]}}

    def test_sizes_n_chips_from_the_spec(self):
        eng = bind_engine(self.SPEC, "bound", device="cpu",
                          metrics=ServingMetrics(), tokens_per_chip_step=8)
        assert eng.n_chips == 2 and eng.step_budget == 16
        assert eng.device == torch.device("cpu")
        assert eng.attend is flash_attention_decode

    @pytest.mark.parametrize("spec", [None, {}, {"containerEdits": {
        "env": ["CUDA_VISIBLE_DEVICES=void"]}}])
    def test_raises_on_zero_devices(self, spec):
        with pytest.raises(ValueError, match="no CUDA device"):
            bind_engine(spec, "none", device="cpu", metrics=ServingMetrics())

    def test_defaults_to_the_first_visible_gpu_and_raises_without_one(
            self, monkeypatch):
        seen = {}
        with monkeypatch.context() as m:
            m.setattr(port_serving, "ServingEngine",
                      lambda name, **kw: seen.update(kw, name=name))
            bind_engine(self.SPEC, "gpu")
        assert seen == {"name": "gpu", "n_chips": 2, "device": "cuda:2"}
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bind_engine(self.SPEC, "gpu", metrics=ServingMetrics())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine("gpu", n_chips=1, metrics=ServingMetrics())
