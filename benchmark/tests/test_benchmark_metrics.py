"""The counter readers on counters as a window leaves them."""

from __future__ import annotations

import pytest

from benchmark.harness import Artifacts
from benchmark.metrics import synth_spec_used_share


def artifacts(**counters) -> Artifacts:
    return Artifacts(model={}, window_s=5.0, device_name="cpu",
                     counters=counters)


@pytest.mark.parametrize("counters, share", [
    # every call skipped: the estimate landed on a bucket never run
    (dict(spec_used=0, spec_fell_back=0, spec_skipped=25), 0.0),
    (dict(spec_used=20, spec_fell_back=0, spec_skipped=5), 80.0),
    (dict(spec_used=3, spec_fell_back=1, spec_skipped=0), 75.0),
])
def test_spec_used_share_counts_every_call_that_looked(counters, share):
    assert synth_spec_used_share.read(artifacts(**counters)) == share


def test_spec_used_share_is_silent_without_calls():
    assert synth_spec_used_share.read(artifacts(
        spec_used=0, spec_fell_back=0, spec_skipped=0)) is None
