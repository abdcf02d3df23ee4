"""Job and worker environment contracts.

Capability parity with the reference's ``JobEnv``/``TrainerEnv``
(python/edl/utils/edl_env.py:30-180): job config merged from CLI args and
``EDL_*`` env vars, elastic node window "min:max", per-node process count,
checkpoint path — and the worker-side env the process manager injects
(reference edl_process.py:54-62 injects ``PADDLE_TRAINER_*``; we inject
``EDL_*`` consumed by :func:`edl_tpu_torch.train.init` to drive
``torch.distributed.init_process_group``).

The local device count comes from ``EDL_DEVICES_PER_PROC`` when set, else
from ``torch.cuda.device_count()`` on first use (the reference's
``get_cuda_device_count``, utils.py:98-120) — control-plane processes that
never ask never import torch.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from edl_tpu_torch.utils.log import get_logger

logger = get_logger("cluster.job_env")

MAX_PODS = 1024  # reference caps the elastic window at 1024 nodes


def _parse_nodes_range(spec: str) -> Tuple[int, int]:
    """Parse "min:max" / "n" (fixed) elastic node windows."""
    if ":" in spec:
        lo_s, hi_s = spec.split(":", 1)
        lo, hi = int(lo_s), int(hi_s)
    else:
        lo = hi = int(spec)
    if not (1 <= lo <= hi <= MAX_PODS):
        raise ValueError("invalid nodes range %r" % spec)
    return lo, hi


def job_identity(
    default_job: str = "", default_pod: str = ""
) -> Tuple[str, str]:
    """``(job_id, pod_id)`` from the environment, with caller-chosen
    fallbacks for off-cluster use.

    This is the ONE place `EDL_JOB_ID`/`EDL_POD_ID` are read with a
    component-specific default: every other reader uses the empty
    string, and the env-registry lint flags conflicting literal
    defaults — the chaos trainee's ``("chaos", "nopod")`` storeless
    identity lives in its *call* here, not in a divergent env read.
    An empty env value counts as unset, matching every call site's
    ``env.get(...) or fallback`` behavior before this helper existed."""
    env = os.environ
    return (
        env.get("EDL_JOB_ID", "") or default_job,
        env.get("EDL_POD_ID", "") or default_pod,
    )


def local_device_count() -> int:
    """CUDA devices this process sees (``EDL_DEVICES_PER_PROC`` overrides).
    Without CUDA the answer is 0, never a made-up 1: the caller decides
    what a CPU-only process means."""
    override = os.environ.get("EDL_DEVICES_PER_PROC")
    if override:
        return int(override)
    import torch  # deliberate lazy import

    return torch.cuda.device_count()


class JobEnv:
    """Launcher-side job configuration (args override env)."""

    def __init__(
        self,
        job_id: Optional[str] = None,
        store_endpoint: Optional[str] = None,
        nodes_range: Optional[str] = None,
        nproc_per_node: Optional[int] = None,
        log_dir: Optional[str] = None,
        ckpt_path: Optional[str] = None,
        compile_cache_dir: Optional[str] = None,
    ) -> None:
        env = os.environ
        self.job_id = job_id or env.get("EDL_JOB_ID", "")
        if not self.job_id:
            raise ValueError("job_id required (flag --job_id or env EDL_JOB_ID)")
        self.store_endpoint = store_endpoint or env.get("EDL_STORE_ENDPOINT", "")
        self.min_nodes, self.max_nodes = _parse_nodes_range(
            nodes_range or env.get("EDL_NODES_RANGE", "1:%d" % MAX_PODS)
        )
        self.nproc_per_node = int(
            nproc_per_node or env.get("EDL_NPROC_PER_NODE", "1")
        )
        self.log_dir = log_dir or env.get("EDL_LOG_DIR", "")
        self.ckpt_path = ckpt_path or env.get("EDL_CKPT_PATH", "")
        # Persistent XLA compilation cache shared by every worker the job
        # ever spawns. Stop-resume elasticity restarts all JAX processes
        # per resize; without this each stage recompiles from scratch and
        # spawn->first-step dominates resize downtime. Job-scoped default
        # (stable across restarts on the host); "none" disables.
        if compile_cache_dir is None:
            compile_cache_dir = env.get("EDL_COMPILE_CACHE_DIR", "")
        if not compile_cache_dir:
            import tempfile

            # Per-user root: on a multi-tenant host another user owning a
            # shared /tmp/edl_xla_cache would make makedirs fail at startup,
            # and loading serialized executables from a world-writable dir
            # is a cache-poisoning surface.
            uid = os.getuid() if hasattr(os, "getuid") else 0
            compile_cache_dir = os.path.join(
                tempfile.gettempdir(), "edl_xla_cache-%d" % uid, self.job_id
            )
        self.compile_cache_dir = (
            "" if compile_cache_dir == "none" else compile_cache_dir
        )

    def __repr__(self) -> str:
        return (
            "JobEnv(job_id=%r, store=%r, nodes=%d:%d, nproc=%d)"
            % (
                self.job_id,
                self.store_endpoint,
                self.min_nodes,
                self.max_nodes,
                self.nproc_per_node,
            )
        )


class WorkerEnv:
    """Worker-process-side view of the env injected by the process manager.

    The training entrypoint reads this (via :func:`edl_tpu_torch.train.init`) to
    join the job: global rank, world size, the coordinator endpoint,
    and the stage token of the cluster generation it belongs to.
    """

    VARS = (
        "EDL_JOB_ID",
        "EDL_POD_ID",
        "EDL_STAGE",
        "EDL_WORKER_RANK",
        "EDL_WORKER_RANK_IN_POD",
        "EDL_NUM_WORKERS",
        "EDL_COORDINATOR",
        "EDL_WORKER_ENDPOINTS",
        "EDL_STORE_ENDPOINT",
        "EDL_CKPT_PATH",
        "EDL_CKPT_LOCAL_DIR",
        "EDL_COMPILE_CACHE_DIR",
        "EDL_NODES_RANGE",
        "EDL_NPROC_PER_NODE",
    )

    def __init__(self) -> None:
        env = os.environ
        self.job_id = env.get("EDL_JOB_ID", "")
        self.pod_id = env.get("EDL_POD_ID", "")
        self.stage = env.get("EDL_STAGE", "")
        self.global_rank = int(env.get("EDL_WORKER_RANK", "0"))
        self.rank_in_pod = int(env.get("EDL_WORKER_RANK_IN_POD", "0"))
        self.world_size = int(env.get("EDL_NUM_WORKERS", "1"))
        self.coordinator = env.get("EDL_COORDINATOR", "")
        self.worker_endpoints: List[str] = [
            e for e in env.get("EDL_WORKER_ENDPOINTS", "").split(",") if e
        ]
        self.store_endpoint = env.get("EDL_STORE_ENDPOINT", "")
        self.ckpt_path = env.get("EDL_CKPT_PATH", "")
        # pod-local checkpoint tier (checkpoint/replicate.py): derived
        # per pod by the launcher from EDL_CKPT_LOCAL_BASE; empty = the
        # classic single-tier layout where ckpt_path is the only dir
        self.ckpt_local_dir = env.get("EDL_CKPT_LOCAL_DIR", "")
        self.compile_cache_dir = env.get("EDL_COMPILE_CACHE_DIR", "")
        # the elastic window, worker-visible (the AOT resize ladder
        # derives its neighbor worlds from it). Absent or malformed =
        # a window pinned to the current world — the ladder is a no-op.
        try:
            self.nproc_per_node = max(1, int(env.get("EDL_NPROC_PER_NODE", "1") or 1))
        except ValueError:
            self.nproc_per_node = 1
        pods = max(1, self.world_size // self.nproc_per_node)
        try:
            self.min_nodes, self.max_nodes = _parse_nodes_range(
                env["EDL_NODES_RANGE"]
            )
        except (KeyError, ValueError):
            self.min_nodes = self.max_nodes = pods

    @property
    def is_rank0(self) -> bool:
        return self.global_rank == 0

    @staticmethod
    def present() -> bool:
        """True when running under the edl_tpu launcher."""
        return "EDL_WORKER_RANK" in os.environ and "EDL_JOB_ID" in os.environ
