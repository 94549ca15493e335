"""Pytest plugin: fail every test that leaves a sanitizer finding behind.

Load it into a run under the sanitizer::

    GPU_DRA_SANITIZE=1 python -m pytest -p k8s_dra_driver_tpu_torch.internal.sanitizer_guard ...
    GPU_DRA_SANITIZE=race python -m pytest -p k8s_dra_driver_tpu_torch.internal.sanitizer_guard ...

Per test it resets the process-global lock-order graph (stray cross-test
edges are not real inversions) and, in race mode, the detector's cells and
reports; after the test it fails the test on any recorded violation (a
``SanitizerError`` raised inside a daemon thread would otherwise vanish
with that thread) and, in race mode, on any race report (reports never
raise into product code, so this is where they surface). Without
``GPU_DRA_SANITIZE`` the fixture does nothing.
"""

from __future__ import annotations

from typing import Iterator

import pytest

from k8s_dra_driver_tpu_torch.pkg import racelab, sanitizer


@pytest.fixture(autouse=True)
def _gpu_sanitizer_guard() -> Iterator[None]:
    if not sanitizer.enabled():
        yield
        return
    race = sanitizer.race_enabled()
    sanitizer.reset()
    if race:
        racelab.reset()
    yield
    leftover = sanitizer.violations()
    assert not leftover, f"sanitizer violations: {leftover}"
    if race:
        races = racelab.reports()
        assert not races, f"data races detected: {races}"
