"""Proactive compile-cache warming for anticipated world sizes.

The port of ``edl_tpu/launch/warm.py``: the same claims
(``warm/{world}``, leased while a shadow stage runs, a permanent
``done:<pod>`` after it; one warm stage per host under ``warm_lock``), the
same budget and order (the largest grow first) and the same knobs.

The elastic window makes resize targets *predictable*: every world size
the job can be resized to is enumerable up front. While the current stage
trains, a :class:`CacheWarmer` thread spawns *shadow stages* — ``w``
short-lived worker processes with the same script, env contract and a
private coordinator — that run two train steps and exit. In the port a
shadow stage adds no entry to the named compile cache
(``EDL_COMPILE_CACHE_DIR``, the kernel-library directory of
``ops/_build.py``): the libraries are named by their sources alone, the
same at every world, and the live stage's first load has already put
them there. What it does is prove that a world's step runs before the
resize arrives.

Shadow stages need devices of their own. Where the workers are placed on
the CPU (the launcher's worker env sets ``CUDA_VISIBLE_DEVICES`` to the
empty string: no card is visible to them) they are free, and shadow
stages run; on the card the live stage owns it, so warming is refused
unless ``EDL_PREWARM_FORCE=1`` says the host has room beside the live
stage (ranks share a card over gloo, ``train/context.group_backend``).

Worker-side contract: the warm processes run the same training script
with ``EDL_WARM_ONLY=1`` (:func:`edl_tpu_torch.train.context.warm_only`);
``ElasticTrainer.fit`` exits 0 after the second completed step — no
checkpoint writes (``EDL_CKPT_PATH`` is cleared), no store traffic
(``EDL_STORE_ENDPOINT`` is cleared), and under ``nice``.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence

from edl_tpu_torch.cluster.job_env import JobEnv
from edl_tpu_torch.cluster.model import Cluster, Pod, Worker
from edl_tpu_torch.launch.process import worker_command, worker_env
from edl_tpu_torch.store.client import StoreClient
from edl_tpu_torch.utils.exceptions import EdlStoreError
from edl_tpu_torch.utils.log import get_logger
from edl_tpu_torch.utils.net import find_free_ports, get_host_ip

logger = get_logger("launch.warm")

WARM_SERVICE = "warm"


def anticipated_world_sizes(job_env: JobEnv) -> List[int]:
    """Every world size the elastic window allows: pods × nproc for each
    pod count in [min_nodes, max_nodes]."""
    return sorted(
        {p * job_env.nproc_per_node
         for p in range(job_env.min_nodes, job_env.max_nodes + 1)}
    )


def _platform_allows_shadow(extra_worker_env: Dict[str, str]) -> bool:
    """Shadow stages run only where their devices are free: workers
    placed on the CPU (``CUDA_VISIBLE_DEVICES`` set to the empty string in
    the worker env, or the launcher's), or ``EDL_PREWARM_FORCE=1``."""
    if os.environ.get("EDL_PREWARM_FORCE") == "1":
        return True
    visible = extra_worker_env.get(
        "CUDA_VISIBLE_DEVICES", os.environ.get("CUDA_VISIBLE_DEVICES")
    )
    return visible is not None and visible.strip() == ""


class CacheWarmer:
    """Background warmer owned by one launcher (pod) process.

    ``note_world(w)`` (called whenever a stage is adopted) records the
    live world size and kicks the thread; the thread walks the pending
    sizes largest-grow-first, claims each through the store, runs one
    shadow stage at a time (host-wide lock), and stops when every
    anticipated size is warmed or the job-wide budget is spent.
    """

    def __init__(
        self,
        job_env: JobEnv,
        pod_id: str,
        training_script: str,
        training_args: Sequence[str] = (),
        extra_worker_env: Optional[Dict[str, str]] = None,
        client: Optional[StoreClient] = None,
        max_sizes: Optional[int] = None,
        warm_timeout: float = 900.0,
    ) -> None:
        self.job_env = job_env
        self.pod_id = pod_id
        self.training_script = training_script
        self.training_args = list(training_args)
        self.extra_worker_env = dict(extra_worker_env or {})
        self._client = client  # edl: guarded-by(self._mu)
        self._owns_client = client is None
        self.max_sizes = max_sizes or int(
            os.environ.get("EDL_PREWARM_MAX", "4")
        )
        self.warm_timeout = warm_timeout
        # guards _pending and _client (launcher + warmer threads): stop()
        # closes the lazily-dialed client the warmer thread creates
        self._mu = threading.Lock()
        self._pending = set(anticipated_world_sizes(job_env))
        self._attempts: Dict[int, int] = {}
        self._current_world = 0
        self._budget = self.max_sizes
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._procs: List[subprocess.Popen] = []
        self._thread: Optional[threading.Thread] = None
        self.warmed: List[int] = []

    # -- lifecycle ---------------------------------------------------------

    def note_world(self, world: int) -> None:
        """The live stage compiles ``world`` itself — drop it and wake."""
        self._current_world = world
        with self._mu:
            self._pending.discard(world)
        if self._thread is None and not self._stop.is_set():
            self._thread = threading.Thread(
                target=self._run, name="cache-warmer", daemon=True
            )
            self._thread.start()
        self._kick.set()

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        self._kill_procs()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        with self._mu:
            owns, client = self._owns_client, self._client
            if owns:
                self._client = None
        if owns and client is not None:
            client.close()

    @staticmethod
    def _max_shadow_world() -> int:
        """Largest shadow stage worth spawning on this host (process
        count, not devices). ``EDL_PREWARM_MAX_WORLD`` overrides."""
        return int(os.environ.get("EDL_PREWARM_MAX_WORLD", "32"))

    # -- store claims ------------------------------------------------------

    def _store(self) -> Optional[StoreClient]:
        with self._mu:
            client = self._client
        if client is not None or not self.job_env.store_endpoint:
            return client
        # dial OUTSIDE the lock: note_world() rides the launcher
        # supervision loop and must never wait behind a 10s connect
        try:
            client = StoreClient(self.job_env.store_endpoint, timeout=10.0)
        except EdlStoreError:
            return None
        with self._mu:
            if self._client is None:
                self._client = client
                return client
            existing = self._client
        client.close()  # lost a (theoretical) publish race
        return existing

    def _global_claims(self):
        """Job-wide claim counts ``(done, in_progress)`` across all pods."""
        client = self._store()
        if client is None:
            used = self.max_sizes - max(self._budget, 0)
            return used, 0
        from edl_tpu_torch.discovery.registry import Registry

        try:
            entries = Registry(client, self.job_env.job_id).get_service(
                WARM_SERVICE
            )
        except EdlStoreError:
            return 0, 0
        done = sum(1 for e in entries if e.value.startswith(b"done:"))
        return done, len(entries) - done

    def _claim(self, world: int):
        """Claim ``world`` with a LEASED registration: a pod killed
        mid-warm releases its claim via lease expiry, so the size stays
        warmable by the survivors. Returns ``(claim, holder)`` where
        ``claim`` is the held Registration, True (no store — single-pod
        usage, nothing to dedupe), or None (another pod holds it; then
        ``holder`` is that pod's claim value — ``done:<pod>`` once the
        size is cached for good). Store errors propagate
        (``EdlStoreError``) so the caller can retry rather than
        permanently skip the size."""
        client = self._store()
        if client is None:
            return True, None
        from edl_tpu_torch.discovery.registry import Registry

        reg, holder = Registry(client, self.job_env.job_id).register_if_absent(
            WARM_SERVICE,
            str(world),
            self.pod_id.encode(),
            ttl=max(30.0, self.warm_timeout / 10),
        )
        return reg, holder

    def _finish_claim(self, world: int, reg, ok: bool) -> None:
        """Success: convert the leased claim to a permanent ``done:``
        record (the size is cached for the job's lifetime; other pods
        stop retrying it). Failure: delete so any pod may retry."""
        if reg is True:
            return
        if ok:
            client = self._store()
            if client is not None:
                from edl_tpu_torch.discovery.registry import Registry

                try:
                    # detach the lease first (permanent put), then stop
                    # the keeper without deleting
                    Registry(client, self.job_env.job_id).set_permanent(
                        WARM_SERVICE, str(world),
                        b"done:" + self.pod_id.encode(),
                    )
                except EdlStoreError:
                    pass
            reg.stop(delete=False)
        else:
            reg.stop(delete=True)

    # -- the warm loop -----------------------------------------------------

    def _run(self) -> None:
        # Let the LIVE stage reach its first step before spawning shadow
        # work: warming that races the stage it serves slows both (the
        # JAX package measured it on a shared-core host)
        delay = float(os.environ.get("EDL_PREWARM_DELAY", "15"))
        if self._stop.wait(timeout=delay):
            return
        while not self._stop.is_set():
            self._kick.wait(timeout=5.0)
            self._kick.clear()
            if self._stop.is_set():
                return
            with self._mu:
                empty = not self._pending
            if empty or self._budget <= 0:
                return
            done, in_progress = self._global_claims()
            if done >= self.max_sizes:
                # job-wide budget: EDL_PREWARM_MAX counts sizes warmed by
                # ANY pod (per-pod budgets let co-located pods multiply
                # shadow work and overlap live transitions)
                return
            if done + in_progress >= self.max_sizes:
                # budget would be met IF the in-progress warms finish —
                # but a SIGKILLed holder's lease expires, so keep the
                # thread alive and re-check instead of exiting for good
                continue
            # Largest feasible grow first: a grow is the expensive
            # first-visit (new hardware idling through a cold compile),
            # the largest world is the costliest compile, and resizes
            # routinely jump straight to the target size. Shrink sizes
            # follow largest (nearest) first. Oversized shadow stages
            # are skipped outright — a wide elastic window must not
            # spawn hundreds of procs here.
            with self._mu:
                feasible = [
                    w for w in self._pending
                    if w <= self._max_shadow_world()
                ]
                if not feasible:
                    return
                grows = [w for w in feasible if w > self._current_world]
                world = max(grows) if grows else max(feasible)
                self._pending.discard(world)
            try:
                claim, holder = self._claim(world)
            except EdlStoreError as exc:
                # transient store trouble (restart, reconnect): the size
                # was claimed by nobody — requeue and retry
                logger.warning("warm: claim world=%d errored (%s)", world, exc)
                self._requeue(world)
                continue
            if claim is None:
                if holder is not None and holder.startswith(b"done:"):
                    # another pod finished this size: drop it for good
                    logger.info("warm: world=%d already cached elsewhere", world)
                else:
                    # leased in-progress claim: if its holder dies, the
                    # lease expires and a later retry here picks it up
                    logger.info(
                        "warm: world=%d being warmed by another pod", world
                    )
                    self._requeue(world)
                continue
            lock = self._host_lock()
            if lock is False:
                # another pod on this host is mid-warm; requeue and retry
                self._finish_claim(world, claim, ok=False)
                self._requeue(world)
                continue
            try:
                self._budget -= 1
                ok = self._warm_one(world)
            except Exception as exc:  # degrade, never kill the warmer
                logger.warning("warm: world=%d failed (%s)", world, exc)
                ok = False
            finally:
                if lock is not None:
                    lock.stop(delete=True)
            self._finish_claim(world, claim, ok)
            if ok:
                self.warmed.append(world)
            else:
                # one retry: refund the budget and requeue so a transient
                # failure (port race, worker crash) doesn't silently
                # disable prewarming for the rest of the job
                attempts = self._attempts.get(world, 0) + 1
                self._attempts[world] = attempts
                if attempts < 2:
                    self._budget += 1
                    self._requeue(world)
            self._kick.set()

    def _requeue(self, world: int) -> None:
        """Put ``world`` back in the pending pool and pace the retry."""
        with self._mu:
            self._pending.add(world)
        if self._stop.wait(timeout=2.0):
            return
        self._kick.set()

    def _host_lock(self):
        """One warm stage per HOST at a time: concurrent shadow stages
        from co-located pods oversubscribe the same cores (and, on the
        card, its memory) and slow each other. Returns a held Registration, None
        (no store → single launcher assumed), or False (lock busy)."""
        client = self._store()
        if client is None:
            return None
        from edl_tpu_torch.discovery.registry import Registry

        try:
            reg, _holder = Registry(client, self.job_env.job_id).register_if_absent(
                WARM_SERVICE + "_lock",
                get_host_ip(),
                self.pod_id.encode(),
                ttl=max(30.0, self.warm_timeout / 10),
            )
        except EdlStoreError:
            # transient store trouble must NOT bypass the one-warm-per-
            # host serialization: report busy so the caller retries
            return False
        return reg if reg is not None else False

    def _warm_one(self, world: int) -> bool:
        """Spawn one shadow stage of ``world`` workers; True on success."""
        addr = get_host_ip()
        try:
            ports = find_free_ports(world)
        except OSError:
            return False
        pod = Pod(
            addr=addr,
            workers=[
                Worker(endpoint="%s:%d" % (addr, ports[i]), rank_in_pod=i)
                for i in range(world)
            ],
        )
        cluster = Cluster.from_pods([pod], stage="warm-%d" % world)
        extra = {
            **self.extra_worker_env,
            "EDL_JOB_ID": self.job_env.job_id,
            "EDL_WARM_ONLY": "1",
            "EDL_STORE_ENDPOINT": "",
            "EDL_CKPT_PATH": "",
            "EDL_COMPILE_CACHE_DIR": self.job_env.compile_cache_dir,
        }
        t0 = time.time()
        log_files = []
        if self.job_env.log_dir:
            os.makedirs(self.job_env.log_dir, exist_ok=True)
        try:
            # shadow compiles yield cores to the live stage; on hosts
            # where warming must outrace an imminent resize (single-core
            # CI, bench rigs) EDL_PREWARM_NICE=0 makes it compete
            nice = os.environ.get("EDL_PREWARM_NICE", "10")
            for worker in pod.workers:
                env = worker_env(cluster, pod, worker, extra)
                cmd = [
                    "nice", "-n", nice,
                    *worker_command(self.training_script, self.training_args),
                ]
                log_file = None
                if self.job_env.log_dir:
                    log_file = open(
                        os.path.join(
                            self.job_env.log_dir,
                            "warmlog.%d.%d" % (world, worker.global_rank),
                        ),
                        "ab",
                    )
                    log_files.append(log_file)
                self._procs.append(
                    subprocess.Popen(
                        cmd,
                        env=env,
                        stdout=log_file or subprocess.DEVNULL,
                        stderr=subprocess.STDOUT if log_file
                        else subprocess.DEVNULL,
                        start_new_session=True,
                    )
                )
            logger.info(
                "warm: shadow stage world=%d spawned (%d procs)",
                world, len(self._procs),
            )
            deadline = time.time() + self.warm_timeout
            codes = [None] * len(self._procs)
            while time.time() < deadline and not self._stop.is_set():
                for i, proc in enumerate(self._procs):
                    if codes[i] is None:
                        codes[i] = proc.poll()
                if all(c is not None for c in codes):
                    break
                time.sleep(0.25)
            ok = all(c == 0 for c in codes)
            if ok:
                logger.info(
                    "warm: world=%d cached in %.1fs", world, time.time() - t0
                )
            else:
                logger.warning(
                    "warm: world=%d failed (exit codes %s)", world, codes
                )
            return ok
        finally:
            self._kill_procs()
            for f in log_files:
                f.close()

    def _kill_procs(self) -> None:
        # start_new_session put each shadow worker in its own session, so
        # killing the process GROUP reaps forked descendants too (data
        # loaders etc.) — same teardown contract as the live workers'
        # terminate_local_workers
        import signal as _signal

        for proc in self._procs:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, _signal.SIGKILL)
                except (OSError, ProcessLookupError):
                    try:
                        proc.kill()
                    except OSError:
                        pass
        for proc in self._procs:
            try:
                proc.wait(timeout=5.0)
            except (subprocess.TimeoutExpired, OSError):
                pass
        self._procs = []


def make_warmer_if_enabled(
    job_env: JobEnv,
    pod_id: str,
    training_script: str,
    training_args: Sequence[str],
    extra_worker_env: Dict[str, str],
    prewarm: bool,
) -> Optional[CacheWarmer]:
    """Launcher hook: a :class:`CacheWarmer` when prewarming makes sense.

    Enabled by the ``--prewarm`` flag or ``EDL_PREWARM=1``; requires a
    compile cache dir, more than one anticipated size, and devices where
    shadow stages can run (CPU workers: ``CUDA_VISIBLE_DEVICES=""``; or
    ``EDL_PREWARM_FORCE=1``).
    """
    if not (prewarm or os.environ.get("EDL_PREWARM") == "1"):
        return None
    if not job_env.compile_cache_dir:
        logger.info("prewarm requested but compile cache disabled; skipping")
        return None
    if len(anticipated_world_sizes(job_env)) <= 1:
        return None
    if not _platform_allows_shadow(extra_worker_env):
        logger.info(
            "prewarm skipped: shadow stages need free devices (CPU workers, "
            "CUDA_VISIBLE_DEVICES=''); on the card the live stage owns it "
            "(EDL_PREWARM_FORCE=1 to override on hosts with room beside it)"
        )
        return None
    return CacheWarmer(
        job_env, pod_id, training_script, training_args, extra_worker_env
    )
