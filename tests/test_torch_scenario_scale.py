"""The port's chaos scenarios on its own stack, on the CPU: the monitor
and scale-plane drills (``monitor-clean``, ``autoscale-churn``,
``autoscale-multijob``) through ``python -m
edl_tpu_torch.tools.chaos_run --device cpu`` — the port's ``Scaler``,
``Monitor`` and launcher pods — held to the JAX scenario's invariant
list (``torch_scenario_case``), with ``tests/test_chaos.py``'s
``firing == []`` for the clean run; and autoscale-multijob's admission
order on recorded flight events."""

import pytest

import torch_scenario_case as case
from edl_tpu_torch.chaos.scenario import admission_order


@pytest.mark.parametrize("name", ["monitor-clean", "autoscale-churn",
                                  "autoscale-multijob"])
def test_scenario(name, tmp_path):
    outcome = case.run(name, tmp_path)
    case.check(name, outcome)
    if name == "monitor-clean":
        assert outcome["info"].get("monitor_health", {}).get("firing") == []
    if name == "autoscale-multijob":
        assert outcome["info"]["harness_a_completed"]


def _pub(ts, pods):
    return {"event": "publish", "ts": ts, "pods": pods, "world": pods}


@pytest.mark.parametrize("boot", [1, 2])
def test_admission_order_is_the_shrink_against_the_first_stage(boot):
    """A run of autoscale-multijob as its flight records fall when B's
    held launchers start before A's leader publishes its shrink: B's
    empty generation (pods 0) precedes A's world-1 stage by 0.1 s, its
    first stage with pods follows it. The port's ``admission_order``
    reads the run as ordered whatever A's bootstrap world; the JAX
    scenario's comparison (A's first world-1 stage against B's first
    publish of any size) reads it as out of order when A bootstrapped
    above world 1, and as ordered, vacuously, when A bootstrapped at 1."""
    a = [_pub(0.0, boot), _pub(0.1, 3),
         {"event": "scale_preempt", "ts": 6.83},
         {"event": "scale_preempt", "ts": 6.84}, _pub(6.90, 1),
         _pub(17.7, 3)]
    b = [_pub(6.80, 0), _pub(8.12, 2)]
    assert admission_order(a, b) == (6.90, 8.12)
    jax_a = min(e["ts"] for e in a if e.get("event") == "publish"
                and e["pods"] == 1)
    jax_b = min(e["ts"] for e in b)
    assert (jax_a <= jax_b) == (boot == 1)
    # B admitted before the shrink is out of order, and so is no shrink
    assert admission_order(a, [_pub(6.85, 2)])[1] < 6.90
    assert admission_order(a[:2], b)[0] is None
