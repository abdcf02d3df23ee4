"""Store-layout and process-contract constants shared by the launcher and
the worker-side train context.

Both sides of the elastic handshake must agree on these, but the launcher
must not import the jax-heavy train package and workers must not import
the launcher — so the shared values live here, in the light cluster
package both already depend on.
"""

# services under the job root (see launch/launcher.py module docstring for
# the full layout)
RES_SERVICE = "pod_resource"
RANK_SERVICE = "pod_rank"
DRAIN_SERVICE = "drain"
CLUSTER_SERVICE = "cluster"
STATUS_SERVICE = "status"
JOB_SERVICE = "job"
# hot restage: worker {pod_id}.{rank_in_pod} -> stage it adopted in-process
HOTADOPT_SERVICE = "hotadopt"

# health plane (see launch/launcher.py for the full keyspace docs):
# preempt/{pod_id} -> json {"deadline": wall-ts, "budget": s, "ts": ...}
#   published by a launcher that received an advance preemption notice
#   (SIGTERM/SIGUSR1). The leader excludes noticed pods from the next
#   generation immediately — no lease-expiry wait — and the pod's own
#   workers see the key through a store watch, take an emergency
#   checkpoint within the budget, and exit DRAINED_EXIT.
PREEMPT_SERVICE = "preempt"
# heartbeat/{pod_id}.{rank_in_pod} -> json {"step": N, "ts": wall-ts,
#   "dt": last-step-seconds, "stage": stage} — per-step worker progress,
#   throttled to EDL_HEARTBEAT_EVERY seconds. The launcher-side straggler
#   watchdog compares each of ITS workers' heartbeat age against a
#   peer-median-derived deadline to tell "stalled" from "uniformly slow".
HEARTBEAT_SERVICE = "heartbeat"

# scale plane (see edl_tpu/scale/ and DESIGN.md "Scale plane"):
# scale/target -> json {"pods": N, "seq": K, "cause": ..., "ts": wall-ts}
#   the autoscaler's reconciliation target for THIS job's world size,
#   written by tools/edl_scaled.py (permanent, last-writer-wins). The
#   leader launcher caps its published world at max(pods, min_nodes)
#   (pods == 0 pauses the job: all pods drained, and the next leader
#   publishes the EMPTY generation so the pause is visible in
#   cluster/current rather than inferred from silence),
#   shrinking via preempt/{pod} notices with cause=autoscale and growing
#   by admitting held pods on the next membership convergence.
# scale/decision -> json rich last-decision record (kind/target/cause/
#   score/seq/trace) — observability only; edl-top's SCHEDULER panel.
SCALE_SERVICE = "scale"

# memory plane (service name owned by edl_tpu/obs/memory.py:MEM_SERVICE;
# see DESIGN.md "Memory observability plane"):
# mem/plan/{world} -> json compile-time MemoryPlan doc (per-kind bytes,
#   total, the publishing device's limit) for the train step compiled at
#   that world — written by the live stage and every AOT ladder rung
#   (permanent, last-writer-wins). The scaler and the launcher's
#   reconcile path read the whole service to fit-gate resize targets
#   (refusals carry cause mem_unfit; growth only is ever clamped).

# exit code a hot-restage-capable worker uses to say "I could not adopt
# the new stage in-process; respawn me" — the launcher treats it as a
# restage request, not a job failure (only in hot-restage mode)
HOT_RESTAGE_EXIT = 75

# exit code of a gracefully drained process: a worker exits with it after
# its emergency checkpoint, and the launcher itself returns it once the
# pod's drain completes — supervisors must treat it as a clean departure,
# never a crash (no failure grace window, no restart of this pod)
DRAINED_EXIT = 76

COMPLETE = b"COMPLETE"
