"""The port's consumer-side exchange link scorer
(trino_tpu_torch/runtime/health.py): EWMA grading over errors and latency,
decay back to HEALTHY, the DEAD breaker's half-open probe window, and the
hedge-delay quantile that paces the spool hedge race.  Ports of the 12 cases
of tests/test_health.py, on an injected clock (no case sleeps)."""

import pytest

try:  # arrow before torch: loaded after it, arrow's parquet writer crashes the process
    import pyarrow  # noqa: F401
except ImportError:
    pass
import torch  # noqa: F401

from trino_tpu_torch.runtime.health import (
    DEAD,
    DEGRADED,
    HEALTHY,
    SUSPECT,
    LinkHealth,
)

PRODUCER = "http://127.0.0.1:9999"


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


@pytest.fixture
def clock():
    return FakeClock()


def test_unknown_link_is_healthy_and_usable():
    lh = LinkHealth()
    assert lh.state(PRODUCER) == HEALTHY
    assert lh.is_usable(PRODUCER)
    assert lh.should_probe(PRODUCER)
    assert lh.impaired() == {}


def test_error_ewma_grades_degraded_suspect_dead(clock):
    lh = LinkHealth(clock=clock)
    for _ in range(10):
        lh.record_success(PRODUCER, 0.01)
    assert lh.state(PRODUCER) == HEALTHY
    # one failure: error EWMA jumps to alpha (0.3) >= suspect threshold
    lh.record_failure(PRODUCER)
    assert lh.state(PRODUCER) == SUSPECT
    # consecutive failures ratchet to DEAD regardless of EWMA
    lh.record_failure(PRODUCER)
    lh.record_failure(PRODUCER)
    assert lh.state(PRODUCER) == DEAD
    assert lh.impaired() == {PRODUCER: DEAD}


def test_latency_only_gray_failure_reaches_suspect(clock):
    """GRAY_SLOW signature: zero errors, latency blows up vs the link's
    own baseline — the scorer must still leave HEALTHY."""
    lh = LinkHealth(clock=clock)
    for _ in range(8):
        lh.record_success(PRODUCER, 0.002)
    assert lh.state(PRODUCER) == HEALTHY
    states = set()
    # gradual slowdown first (5x the baseline), then the full gray stall:
    # the grade must walk HEALTHY -> DEGRADED -> SUSPECT
    for _ in range(6):
        lh.record_success(PRODUCER, 0.010)
        states.add(lh.state(PRODUCER))
    for _ in range(20):
        lh.record_success(PRODUCER, 0.5)  # 250x the baseline
        states.add(lh.state(PRODUCER))
    assert lh.state(PRODUCER) == SUSPECT
    assert DEGRADED in states  # passed through the intermediate grade
    # never DEAD: a slow link is not a dead link
    assert DEAD not in states


def test_success_decays_error_ewma_back_to_healthy(clock):
    lh = LinkHealth(clock=clock)
    for _ in range(5):
        lh.record_success(PRODUCER, 0.01)
    lh.record_failure(PRODUCER)
    assert lh.state(PRODUCER) == SUSPECT
    for _ in range(20):
        lh.record_success(PRODUCER, 0.01)
    assert lh.state(PRODUCER) == HEALTHY


def test_dead_link_half_open_probe_window(clock):
    lh = LinkHealth(clock=clock, probe_interval=2.0)
    for _ in range(3):
        lh.record_failure(PRODUCER)
    assert lh.state(PRODUCER) == DEAD
    # window closed right after the failure: not usable, no probe
    assert not lh.is_usable(PRODUCER)
    assert not lh.should_probe(PRODUCER)
    clock.advance(2.5)
    # window open: exactly one fetch loop wins the probe slot
    assert lh.is_usable(PRODUCER)
    assert lh.should_probe(PRODUCER)
    # the probe stamp closes the window for concurrent loops
    assert not lh.should_probe(PRODUCER)


def test_successful_probe_fully_restores_dead_link(clock):
    lh = LinkHealth(clock=clock, probe_interval=2.0)
    for _ in range(4):
        lh.record_failure(PRODUCER)
    assert lh.state(PRODUCER) == DEAD
    clock.advance(3.0)
    assert lh.should_probe(PRODUCER)
    lh.record_success(PRODUCER, 0.01)
    # same contract as the worker breaker: one good probe = full restore
    assert lh.state(PRODUCER) == HEALTHY
    assert lh.is_usable(PRODUCER)


def test_failed_probe_keeps_link_dead_and_recloses_window(clock):
    lh = LinkHealth(clock=clock, probe_interval=2.0)
    for _ in range(3):
        lh.record_failure(PRODUCER)
    clock.advance(3.0)
    assert lh.should_probe(PRODUCER)
    lh.record_failure(PRODUCER)
    assert lh.state(PRODUCER) == DEAD
    assert not lh.should_probe(PRODUCER)  # window re-anchored


def test_transition_callback_fires_outside_lock(clock):
    seen = []
    lh = LinkHealth(
        clock=clock,
        on_transition=lambda p, old, new: seen.append((p, old, new)),
    )
    for _ in range(3):
        lh.record_failure(PRODUCER)
    assert (PRODUCER, HEALTHY, SUSPECT) in seen
    assert seen[-1][2] == DEAD
    # callbacks may re-enter the scorer (flight recorder handlers do)
    seen.clear()
    lh2 = LinkHealth(
        clock=clock, on_transition=lambda p, o, n: lh2.state(p)
    )
    lh2.record_failure(PRODUCER)  # deadlock here = regression


def test_hedge_delay_default_until_enough_history(clock):
    lh = LinkHealth(clock=clock)
    assert lh.hedge_delay(PRODUCER, default=0.25) == 0.25
    for _ in range(3):
        lh.record_success(PRODUCER, 0.01)
    assert lh.hedge_delay(PRODUCER, default=0.25) == 0.25  # < 4 samples


def test_hedge_delay_tracks_latency_quantile(clock):
    lh = LinkHealth(clock=clock)
    for i in range(50):
        lh.record_success(PRODUCER, 0.010)
    lh.record_success(PRODUCER, 0.100)  # one tail outlier
    # p50 x3 stays near the typical latency, not the outlier (floor=0
    # here: the default 0.05 floor would clip a 30ms answer)
    mid = lh.hedge_delay(PRODUCER, quantile=0.5, multiplier=3.0, floor=0.0)
    assert mid == pytest.approx(0.030, rel=0.2)
    # p100 x3 sees the outlier
    assert lh.hedge_delay(PRODUCER, quantile=1.0, multiplier=3.0) == (
        pytest.approx(0.300, rel=0.01)
    )
    # the floor bounds pathologically fast links
    assert lh.hedge_delay(PRODUCER, quantile=0.0, floor=0.05) == 0.05


def test_snapshot_wire_shape(clock):
    lh = LinkHealth(clock=clock)
    lh.record_success(PRODUCER, 0.010)
    lh.record_failure(PRODUCER)
    snap = lh.snapshot()
    cell = snap[PRODUCER]
    assert cell["state"] == SUSPECT
    assert cell["samples"] == 2
    assert cell["consecutive_failures"] == 1
    assert cell["latency_ewma_ms"] == pytest.approx(10.0)
    assert cell["baseline_ms"] == pytest.approx(10.0)
    assert 0.0 < cell["error_ewma"] <= 1.0


def test_forget_and_reset(clock):
    lh = LinkHealth(clock=clock)
    lh.record_failure(PRODUCER)
    lh.record_failure("http://other:1")
    lh.forget(PRODUCER)
    assert lh.state(PRODUCER) == HEALTHY
    assert lh.snapshot().keys() == {"http://other:1"}
    lh.reset()
    assert lh.snapshot() == {}
