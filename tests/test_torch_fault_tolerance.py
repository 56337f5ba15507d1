"""The port's control-plane fault tolerance against the reference:
heartbeats, stragglers, restart policy, elastic mesh sizing, failure
injection.

``repro_torch.train.fault_tolerance`` is the port's own copy of the
reference's pure-Python module (the reference's package imports JAX). The
reference's unit tests (``tests/test_fault_tolerance.py``) run here
against the port, and seeded random telemetry and failure events give
both modules the same answers, exactly: there is no arithmetic that could
differ.
"""

import random

import pytest

from repro.train import fault_tolerance as jft
from repro_torch.train.fault_tolerance import (FailureInjector,
                                               HeartbeatMonitor,
                                               RestartPolicy,
                                               StragglerDetector,
                                               elastic_mesh_shape)


def test_heartbeat_detects_dead_host():
    mon = HeartbeatMonitor(timeout_s=10.0)
    mon.beat(0, now=100.0)
    mon.beat(1, now=100.0)
    mon.beat(0, now=150.0)
    assert mon.dead_hosts(now=155.0) == [1]
    assert not mon.healthy(now=155.0)
    mon.beat(1, now=156.0)
    assert mon.healthy(now=157.0)


def test_straggler_mad_detection():
    det = StragglerDetector(window=16, k_mad=5.0, min_samples=4)
    for step in range(8):
        for host in range(8):
            t = 1.0 + 0.01 * (step % 3)
            if host == 3:
                t *= 4.0               # persistent straggler
            det.record(host, t)
    assert det.stragglers() == [3]


def test_straggler_tolerates_jitter():
    det = StragglerDetector(window=16, k_mad=5.0, min_samples=4)
    import random
    rnd = random.Random(0)
    for step in range(16):
        for host in range(8):
            det.record(host, 1.0 + rnd.uniform(-0.05, 0.05))
    assert det.stragglers() == []


def test_straggler_needs_min_samples():
    det = StragglerDetector(min_samples=8)
    det.record(0, 1.0)
    det.record(1, 100.0)
    assert det.stragglers() == []


def test_restart_policy_backoff_and_abort():
    pol = RestartPolicy(max_restarts=3, backoff_base_s=1.0, backoff_cap_s=10.0)
    a0 = pol.next_action(0, [], 64)
    a1 = pol.next_action(1, [], 64)
    assert a0 == ("restart", 1.0)
    assert a1 == ("restart", 2.0)
    assert pol.next_action(3, [], 64)[0] == "abort"


def test_restart_policy_reslice_on_mass_failure():
    pol = RestartPolicy()
    action, _ = pol.next_action(0, dead_hosts=list(range(8)), n_hosts=64)
    assert action == "reslice"
    action, _ = pol.next_action(0, dead_hosts=[], n_hosts=64)
    assert action == "restart"


def test_elastic_mesh_shape():
    assert elastic_mesh_shape(256, 16) == (16, 16)
    assert elastic_mesh_shape(240, 16) == (15, 16)   # one host of 16 lost
    assert elastic_mesh_shape(17, 16) == (1, 16)
    with pytest.raises(ValueError):
        elastic_mesh_shape(8, 16)


def test_failure_injector():
    inj = FailureInjector(fail_at_steps=(5, 9), kind="crash")
    assert inj.check(4) is None
    assert inj.check(5) == "crash"
    assert inj.check(9) == "crash"


@pytest.mark.parametrize("seed", range(4))
def test_straggler_verdicts_equal_the_reference(seed):
    rnd = random.Random(seed)
    ours, theirs = StragglerDetector(min_samples=4), jft.StragglerDetector(
        min_samples=4)
    slow = rnd.randrange(8)
    for _ in range(40):
        for host in range(8):
            t = rnd.uniform(0.9, 1.1) * (rnd.uniform(1, 6) if host == slow
                                         else 1.0)
            ours.record(host, t)
            theirs.record(host, t)
        assert ours.stragglers() == theirs.stragglers()


@pytest.mark.parametrize("seed", range(4))
def test_restart_and_heartbeat_decisions_equal_the_reference(seed):
    rnd = random.Random(seed)
    ours, theirs = RestartPolicy(max_restarts=8), jft.RestartPolicy(
        max_restarts=8)
    mon, jmon = HeartbeatMonitor(timeout_s=5.0), jft.HeartbeatMonitor(
        timeout_s=5.0)
    for i in range(50):
        host, now = rnd.randrange(16), float(i)
        mon.beat(host, now=now)
        jmon.beat(host, now=now)
        probe = now + rnd.uniform(0, 10)
        assert mon.dead_hosts(now=probe) == jmon.dead_hosts(now=probe)
        assert mon.healthy(now=probe) == jmon.healthy(now=probe)
        n = rnd.randrange(12)
        dead = sorted(rnd.sample(range(64), rnd.randrange(9)))
        assert ours.next_action(n, dead, 64) == theirs.next_action(n, dead,
                                                                   64)
    later = 60.0
    assert mon.dead_hosts(now=later) == jmon.dead_hosts(now=later)
    for n, tp in ((256, 16), (240, 16), (17, 16), (9, 2)):
        assert elastic_mesh_shape(n, tp) == jft.elastic_mesh_shape(n, tp)
