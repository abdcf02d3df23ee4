"""The memory plane: plans, watermarks, census, OOM forensics.

The torch half of ``edl_tpu/obs/memory.py``, with the same store keys,
plan schema, metric names and flight records, so the launcher's fit cap
(``_mem_fit_cap``), the scale plane and the monitor's ``hbm-pressure`` /
``oom-detected`` rules read a torch worker as they read a JAX one.

**(a) Plans.** The JAX package asks XLA for the compiled step's memory
plan. Eager PyTorch has no compiled step: :meth:`MemoryPlan.from_measured`
is measured instead, from the warm-up step's peak
(``torch.cuda.max_memory_allocated`` after the stage's first step),
split into ``argument`` (the parameters and the optimizer's state) and
``temp`` (the rest of the peak); ``output``, ``alias`` and
``generated_code`` are 0. The doc keeps :data:`PLAN_KINDS`. XLA's
donation cross-check has no counterpart (an eager step updates in place)
and is not applicable here.

**(b) Fit checks.** :func:`fit_check` / :func:`fit_cap` over published
plans, as in the JAX package.

**(c) Census and watermarks.** :func:`census` lists the caching
allocator's live blocks (``torch.cuda.memory_snapshot``: sizes only, no
device sync), aggregated by size; the stage watermark follows
``torch.cuda.memory_stats``.

**(d) OOM forensics.** :meth:`MemoryPlane.oom_guard` wraps step
dispatch: ``torch.cuda.OutOfMemoryError`` (or an error whose text says
RESOURCE_EXHAUSTED / out of memory, :func:`is_oom`) triggers a
crash-safe forensics bundle and an fsync'd ``oom`` flight record before
the error propagates.

Everything is best-effort telemetry: no method raises into training.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("obs.memory")

__all__ = [
    "MEM_SERVICE",
    "PLAN_KINDS",
    "MemoryPlan",
    "MemoryPlane",
    "census",
    "census_every",
    "fit_check",
    "fit_cap",
    "harvest_plan",
    "is_oom",
    "mem_margin",
    "publish_plan",
    "read_plans",
]

# store keyspace (see cluster/contract.py layout docs):
# mem/plan/{world} -> json MemoryPlan doc for the train step compiled at
#   ``world`` processes — written by whichever process compiled it (the
#   live stage or an AOT ladder rung), permanent, last-writer-wins. The
#   scale plane and the launcher's reconcile path read the whole service
#   to fit-gate resize targets.
MEM_SERVICE = "mem"
PLAN_KEY_FMT = "plan/%d"

# memory_analysis() legs, in CompiledMemoryStats attribute order
PLAN_KINDS = ("argument", "output", "temp", "alias", "generated_code")

# top-K block sizes the census keeps per pass: enough to name the owners
# of the card's memory without turning the flight record into a heap dump
CENSUS_TOP_K = 8


def mem_margin() -> float:
    """``EDL_MEM_MARGIN``: fraction of the device limit held back as
    safety headroom by every fit check (fragmentation, allocator slack,
    collectives scratch XLA does not plan). Single read site."""
    try:
        return float(os.environ.get("EDL_MEM_MARGIN", "0.08"))
    except ValueError:
        return 0.08


def census_every() -> int:
    """``EDL_MEM_CENSUS_EVERY``: steps between census passes (0 disables
    the census entirely). Single read site."""
    try:
        return int(os.environ.get("EDL_MEM_CENSUS_EVERY", "200"))
    except ValueError:
        return 200


class MemoryPlan:
    """One executable's compile-time memory footprint, by kind (bytes).

    ``limit`` is the publishing device's capacity (bytes_limit) stamped
    at harvest time, so a deviceless reader — the scaler, the launcher's
    reconcile path — can fit-check the plan without ever seeing the
    device (0 = unknown, which always fits: the gate refuses only on
    positive evidence)."""

    __slots__ = ("argument", "output", "temp", "alias", "generated_code",
                 "world", "ts", "limit")

    def __init__(
        self,
        argument: float = 0.0,
        output: float = 0.0,
        temp: float = 0.0,
        alias: float = 0.0,
        generated_code: float = 0.0,
        world: int = 0,
        ts: float = 0.0,
        limit: float = 0.0,
    ) -> None:
        self.argument = float(argument)
        self.output = float(output)
        self.temp = float(temp)
        self.alias = float(alias)
        self.generated_code = float(generated_code)
        self.world = int(world)
        self.ts = float(ts)
        self.limit = float(limit)

    def total(self) -> float:
        """Planned peak residency: arguments + outputs + temps + code.
        Aliased (donated) bytes are NOT double-counted — they live
        inside the argument figure and are the part the output reuses."""
        return (
            self.argument + self.output + self.temp + self.generated_code
            - min(self.alias, self.output)
        )

    def by_kind(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in PLAN_KINDS}

    def to_doc(self) -> Dict[str, Any]:
        doc = self.by_kind()
        doc["total"] = self.total()
        doc["world"] = self.world
        doc["ts"] = self.ts
        doc["limit"] = self.limit
        return doc

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "MemoryPlan":
        return cls(
            **{k: float(doc.get(k, 0.0)) for k in PLAN_KINDS},
            world=int(doc.get("world", 0)),
            ts=float(doc.get("ts", 0.0)),
            limit=float(doc.get("limit", 0.0)),
        )

    @classmethod
    def from_measured(cls, peak: float, argument: float, world: int = 0,
                      limit: float = 0.0) -> "MemoryPlan":
        """A plan measured from a step's peak: ``argument`` bytes (the
        parameters and the optimizer's state) and the rest of the peak
        as ``temp``."""
        return cls(argument=argument, temp=max(0.0, peak - argument),
                   world=world, ts=time.time(), limit=limit)


def _tensor_bytes(tree) -> float:
    """Bytes this rank holds: a ``DTensor`` (FSDP2's sharded parameters
    and optimizer state) counts its local shard only."""
    if torch.is_tensor(tree):
        local = getattr(tree, "_local_tensor", tree)
        return float(local.numel() * local.element_size())
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0.0


def state_bytes(state) -> float:
    """Bytes of a ``TrainState``'s parameters and optimizer state (or of
    a ``name -> tensor`` dict) on this rank: the plan's ``argument``.
    Under FSDP a rank holds its shards, so a plan published at fsdp 2
    shows about half the state bytes of fsdp 1."""
    params = getattr(state, "params", state)
    total = _tensor_bytes(params)
    opt = getattr(getattr(state, "opt_state", None), "optimizer", None)
    if opt is not None:
        total += _tensor_bytes(list(opt.state.values()))
    return total


def harvest_plan(state, device=None, world: int = 0) -> Optional[MemoryPlan]:
    """The plan of the step that just ran on ``device``: its peak
    (``max_memory_allocated`` since the last reset) split into the
    state's bytes (``argument``) and the rest (``temp``). On the CPU (no
    allocator peak) the plan holds the state's bytes alone. None on any
    failure: the plan is telemetry, never a correctness dependency."""
    try:
        argument = state_bytes(state)
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            peak = float(torch.cuda.max_memory_allocated(dev))
        else:
            peak = argument
        return MemoryPlan.from_measured(peak, argument, world=world)
    except Exception as exc:  # noqa: BLE001
        logger.debug("memory plan harvest failed: %s", exc)
        return None


def publish_plan(client, job_id: str, plan: MemoryPlan) -> bool:
    """Publish ``plan`` under ``mem/plan/{world}`` (permanent,
    last-writer-wins — a recompile at the same world supersedes).
    Best-effort: False on store trouble, never raises."""
    if client is None or not job_id or plan.world <= 0:
        return False
    try:
        from edl_tpu_torch.discovery.registry import Registry

        Registry(client, job_id).set_permanent(
            MEM_SERVICE,
            PLAN_KEY_FMT % plan.world,
            json.dumps(plan.to_doc()).encode(),
        )
        return True
    except Exception as exc:  # noqa: BLE001 — store blip: next harvest retries
        logger.debug("mem plan publish failed: %s", exc)
        return False


def read_plans(client, job_id: str) -> Dict[int, MemoryPlan]:
    """Every published ``mem/plan/{world}`` doc, keyed by world.
    Best-effort: {} on store trouble (an absent plan must read as
    "unknown", never as "unfit")."""
    if client is None or not job_id:
        return {}
    try:
        from edl_tpu_torch.discovery.registry import Registry

        metas = Registry(client, job_id).get_service(MEM_SERVICE)
    except Exception:  # noqa: BLE001 — store blip: fit gate sees no plans
        return {}
    out: Dict[int, MemoryPlan] = {}
    for meta in metas:
        name = getattr(meta, "name", "")
        if not name.startswith("plan/"):
            continue
        try:
            world = int(name[len("plan/"):])
            out[world] = MemoryPlan.from_doc(json.loads(meta.value))
        except (ValueError, TypeError):
            continue
    return out


# -- (b) fit checks ------------------------------------------------------------


def fit_check(
    plan_total: float, limit: float, margin: Optional[float] = None
) -> bool:
    """Does a plan of ``plan_total`` bytes fit a device of ``limit``
    bytes, after holding back the safety ``margin`` fraction? A
    non-positive limit means "unknown capacity" and always fits — the
    gate refuses only on positive evidence."""
    if limit <= 0 or plan_total <= 0:
        return True
    m = mem_margin() if margin is None else margin
    return plan_total <= limit * (1.0 - m)


def fit_cap(
    plans: Dict[int, MemoryPlan],
    limit: float = 0.0,
    margin: Optional[float] = None,
) -> Optional[int]:
    """The largest published world that still fits (None when no plan
    with a usable limit is published — unknown never caps; 0 when every
    known plan is over-limit). ``limit`` overrides the per-plan device
    limit stamped at harvest time; left at 0, each plan is checked
    against its own embedded limit."""
    fitting: List[int] = []
    judged = False
    for w, p in plans.items():
        lim = limit if limit > 0 else p.limit
        if lim <= 0 or p.total() <= 0:
            continue  # no verdict possible for this world
        judged = True
        if fit_check(p.total(), lim, margin):
            fitting.append(w)
    if not judged:
        return None
    return max(fitting) if fitting else 0


# -- (c) runtime census --------------------------------------------------------


def census(device=None, top_k: int = CENSUS_TOP_K) -> Dict[str, Any]:
    """One census pass over the caching allocator's live blocks on
    ``device`` (``torch.cuda.memory_snapshot``: block sizes only, no
    device sync, no value reads). Returns ``{buffers, bytes, top: [{shape,
    dtype, nbytes, count}...]}`` with the top-K aggregated by block size
    (the allocator knows sizes, not shapes: ``shape`` names the size and
    ``dtype`` is ``"block"``). Empty for the CPU."""
    empty = {"buffers": 0, "bytes": 0.0, "top": []}
    try:
        dev = torch.device(device) if device is not None else None
        if dev is None or dev.type != "cuda":
            return empty
        segments = torch.cuda.memory_snapshot()
    except Exception:  # noqa: BLE001 — no allocator: empty census
        return empty
    total = 0.0
    count = 0
    groups: Dict[int, List[float]] = {}
    for seg in segments:
        if dev.index is not None and seg.get("device", dev.index) != dev.index:
            continue
        for block in seg.get("blocks", ()):
            if block.get("state") != "active_allocated":
                continue
            size = int(block.get("requested_size") or block.get("size", 0))
            total += size
            count += 1
            groups.setdefault(size, []).append(float(size))
    top = sorted(
        (
            {"shape": "[%d bytes]" % size, "dtype": "block",
             "nbytes": sum(sizes), "count": len(sizes)}
            for size, sizes in groups.items()
        ),
        key=lambda g: -g["nbytes"],
    )[:top_k]
    return {"buffers": count, "bytes": total, "top": top}


def is_oom(exc: BaseException) -> bool:
    """Is this the allocator saying no? ``torch.cuda.OutOfMemoryError``,
    or an error whose text carries RESOURCE_EXHAUSTED / out of memory
    (the JAX package's device OOM, which the chaos trainee's injected
    drill raises)."""
    oom_type = getattr(torch.cuda, "OutOfMemoryError", None)
    if oom_type is not None and isinstance(exc, oom_type):
        return True
    text = "%s: %s" % (type(exc).__name__, exc)
    return (
        "RESOURCE_EXHAUSTED" in text
        or "Out of memory" in text
        or "out of memory" in text
    )


class _OomGuard:
    """Context manager half of :meth:`MemoryPlane.oom_guard`."""

    __slots__ = ("_plane", "_ctx")

    def __init__(self, plane: "MemoryPlane", ctx: Dict[str, Any]) -> None:
        self._plane = plane
        self._ctx = ctx

    def __enter__(self) -> "_OomGuard":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None and is_oom(exc):
            self._plane.forensics(exc, **self._ctx)
        return False  # always propagate: drain/restage owns recovery


class MemoryPlane:
    """One stage's memory observability: plans, watermarks, census, OOM.

    Created per training stage (train/loop.py, chaos/trainee.py) next to
    ``StepTelemetry``. :meth:`arm` before the stage's first step resets
    the allocator's peak, so the plan :meth:`harvest` measures after
    that step is the step's.
    :meth:`close` releases the gauge bindings. Every public method is
    best-effort: the plane observes training, it never gates it.
    """

    def __init__(
        self,
        device=None,
        stage: str = "",
        rank: int = 0,
        client=None,
        job_id: str = "",
        registry: Optional[obs_metrics.MetricsRegistry] = None,
    ) -> None:
        self._reg = (
            registry if registry is not None else obs_metrics.default_registry()
        )
        self._device = torch.device(device) if device is not None else None
        self.stage = stage
        self.rank = rank
        self._client = client
        self._job_id = job_id
        self._lock = threading.Lock()
        self.plan: Optional[MemoryPlan] = None
        self._census_interval = census_every()
        self._last_census_step: Optional[int] = None
        # stage-local watermark: peak of whatever residency signal this
        # device has (allocated bytes, else the census byte total)
        self._peak = 0.0
        self._in_use = 0.0
        self._limit = 0.0
        self._reserved = 0.0
        self._frag = 0.0
        self._census_bytes = 0.0
        self._census_buffers = 0.0
        self._m_oom = self._reg.counter(
            "edl_train_oom_total",
            "RESOURCE_EXHAUSTED errors caught at step dispatch (forensics "
            "bundle captured for each)",
        )
        self._m_census = self._reg.counter(
            "edl_mem_census_passes_total",
            "live-buffer census passes completed by the memory plane",
        )
        self._m_plan = self._reg.gauge(
            "edl_train_hbm_plan_bytes",
            "compile-time memory plan for the live train step, by kind "
            "(memory_analysis: argument/output/temp/alias/generated_code)",
        )
        self._binding = obs_metrics.bind_gauges(
            [
                (
                    "edl_device_hbm_peak_bytes",
                    "stage-local high-water mark of device memory in use "
                    "(reset on stage start; census-derived on backends "
                    "without memory_stats)",
                    lambda: self._peak,
                ),
                (
                    "edl_device_hbm_reserved_bytes",
                    "allocator bytes reserved from the device (0 when the "
                    "backend does not report reservations)",
                    lambda: self._reserved,
                ),
                (
                    "edl_device_hbm_utilization_ratio",
                    "device memory in use over its limit (the hbm-pressure "
                    "rule's signal; 0 when the backend reports no limit)",
                    self._utilization,
                ),
                (
                    "edl_device_hbm_fragmentation_ratio",
                    "reserved-but-unused fraction of the allocator's "
                    "reservation — a fragmentation/slack estimate",
                    lambda: self._frag,
                ),
                (
                    "edl_mem_census_live_bytes",
                    "total bytes of live jax arrays at the last census pass",
                    lambda: self._census_bytes,
                ),
                (
                    "edl_mem_census_live_buffers",
                    "live jax array count at the last census pass",
                    lambda: self._census_buffers,
                ),
            ],
            self._reg,
        )

    # -- plans -------------------------------------------------------------

    def arm(self) -> None:
        """Before the step :meth:`harvest` measures: reset the allocator's
        peak (the state's build and restore are not the step's)."""
        try:
            if self._device is not None and self._device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self._device)
        except Exception as exc:  # noqa: BLE001
            logger.debug("memory plane arm failed: %s", exc)

    def harvest(self, state, world: int = 0) -> Optional[MemoryPlan]:
        """Measure the plan of the step that just ran (see
        :func:`harvest_plan`), export the per-kind gauges, publish it to
        the store and leave an fsync'd ``mem_plan`` flight record."""
        plan = harvest_plan(state, self._device, world=world)
        if plan is None:
            return None
        self._sample_stats()
        with self._lock:
            plan.limit = self._limit
            self.plan = plan
        for kind, v in plan.by_kind().items():
            self._m_plan.set(v, kind=kind)
        self._m_plan.set(plan.total(), kind="total")
        publish_plan(self._client, self._job_id, plan)
        obs_events.record(
            "mem_plan", fsync=True, component="memory", stage=self.stage,
            rank=self.rank, world=world,
            total_bytes=plan.total(), temp_bytes=plan.temp,
            alias_bytes=plan.alias,
        )
        return plan

    def harvest_rung(self, plan: MemoryPlan, world: int) -> Optional[MemoryPlan]:
        """Publish an AOT ladder rung's plan (``train/aot.
        make_neighbor_planner``: built from the live plan, no step run)
        under ``mem/plan/{world}``, stamped with the live device limit,
        with a ``mem_plan`` flight record (``rung=True``). Does NOT touch
        the live-stage plan, its gauges or the allocator's peak."""
        if plan is None:
            return None
        with self._lock:
            plan.limit = self._limit
        plan.world = world
        publish_plan(self._client, self._job_id, plan)
        obs_events.record(
            "mem_plan", fsync=True, component="memory", stage=self.stage,
            rank=self.rank, world=world, rung=True,
            total_bytes=plan.total(), temp_bytes=plan.temp,
            alias_bytes=plan.alias,
        )
        return plan

    # -- runtime sampling --------------------------------------------------

    def _utilization(self) -> float:
        if self._limit <= 0:
            return 0.0
        return self._in_use / self._limit

    def _sample_stats(self) -> None:
        """Refresh in_use/limit/peak/reserved from the allocator, updating
        the stage watermark. A host call, no device sync."""
        from edl_tpu_torch.obs import profile as obs_profile

        stats = (
            obs_profile.device_memory_stats_full(self._device)
            if self._device is not None else None
        )
        with self._lock:
            if stats:
                self._in_use = stats.get("bytes_in_use", 0.0)
                self._limit = stats.get("bytes_limit", 0.0)
                self._reserved = stats.get("bytes_reserved", 0.0)
                peak = max(
                    self._in_use, stats.get("peak_bytes_in_use", 0.0)
                )
                if self._reserved > 0:
                    self._frag = max(
                        0.0, (self._reserved - self._in_use) / self._reserved
                    )
            else:
                # the CPU: the census byte total is the only signal
                peak = self._census_bytes
            self._peak = max(self._peak, peak)

    def on_step(self, step_idx: int) -> None:
        """Per-step hook: throttled stats sample + census. Never syncs
        the device, never raises. Off the census cadence this is one
        comparison and a return."""
        every = self._census_interval
        if every <= 0:
            return
        if (
            self._last_census_step is not None
            and step_idx - self._last_census_step < every
        ):
            return
        self._last_census_step = step_idx
        try:
            self.run_census(step_idx)
        except Exception as exc:  # noqa: BLE001 — telemetry must not break the step
            logger.debug("mem census failed at step %d: %s", step_idx, exc)

    def run_census(self, step_idx: int = -1, fsync: bool = False) -> Dict[str, Any]:
        """One unthrottled census + stats sample; flight-records the
        result (fsync'd only when forensics asks)."""
        snap = census(self._device)
        with self._lock:
            self._census_bytes = float(snap["bytes"])
            self._census_buffers = float(snap["buffers"])
        self._sample_stats()
        self._m_census.inc()
        obs_events.record(
            "mem_census", fsync=fsync, component="memory", stage=self.stage,
            rank=self.rank, step=step_idx,
            live_bytes=snap["bytes"], live_buffers=snap["buffers"],
            top=snap["top"],
        )
        return snap

    def reset_peak(self) -> None:
        """Per-stage watermark reset (stage start / after a restage)."""
        with self._lock:
            self._peak = 0.0

    def watermark(self) -> float:
        with self._lock:
            return self._peak

    def plan_accuracy(self) -> Optional[float]:
        """Plan-vs-actual score: min/max ratio of the plan's total and
        the stage watermark, in percent. None until both exist."""
        with self._lock:
            plan, peak = self.plan, self._peak
        if plan is None or peak <= 0:
            return None
        planned = plan.total()
        if planned <= 0:
            return None
        acc = 100.0 * min(planned, peak) / max(planned, peak)
        self._reg.gauge(
            "edl_train_hbm_plan_accuracy_pct",
            "plan-vs-actual: min/max ratio of the compile-time plan total "
            "and the stage's runtime high-water mark, in percent",
        ).set(acc)
        return acc

    # -- (d) OOM forensics -------------------------------------------------

    def oom_guard(self, **ctx) -> _OomGuard:
        """Wrap step dispatch: ``with plane.oom_guard(step=n): step(...)``.
        An OOM triggers :meth:`forensics` and then propagates unchanged
        into the drain/restage machinery."""
        return _OomGuard(self, ctx)

    def forensics(self, exc: BaseException, **ctx) -> Optional[str]:
        """Crash-safe OOM evidence, captured while the heap that failed
        is still resident: an unthrottled census, the allocator's
        snapshot (``oom-*.memsnap``, on the card), the active plan and an
        fsync'd ``oom`` flight record — then a durable JSON bundle.
        Returns the bundle path (None when no flight dir is set)."""
        self._m_oom.inc()
        try:
            snap = self.run_census(fsync=True)
        except Exception:  # noqa: BLE001 — forensics on a dying process: best effort
            snap = {"buffers": 0, "bytes": 0.0, "top": []}
        flight_dir = os.environ.get(obs_events.ENV_DIR)
        bundle_path = None
        profile_path = None
        if flight_dir:
            try:
                os.makedirs(flight_dir, exist_ok=True)
                stamp = "%d.%d" % (int(time.time() * 1000), os.getpid())
                if self._device is not None and self._device.type == "cuda":
                    profile_path = os.path.join(
                        flight_dir, "oom-%s.memsnap" % stamp
                    )
                    try:
                        torch.cuda.memory._dump_snapshot(profile_path)
                    except Exception:  # noqa: BLE001 — optional evidence
                        profile_path = None
                bundle_path = os.path.join(flight_dir, "oom-%s.json" % stamp)
                bundle = {
                    "ts": time.time(),
                    "stage": self.stage,
                    "rank": self.rank,
                    "error": "%s: %s" % (type(exc).__name__, exc),
                    "plan": self.plan.to_doc() if self.plan else None,
                    "census": snap,
                    "peak_bytes": self.watermark(),
                    "in_use_bytes": self._in_use,
                    "limit_bytes": self._limit,
                    "memory_profile": profile_path,
                    "ctx": {k: str(v) for k, v in ctx.items()},
                }
                tmp = bundle_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(bundle, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, bundle_path)
            except OSError as io_exc:
                logger.warning("oom bundle write failed: %s", io_exc)
                bundle_path = None
        obs_events.record(
            "oom", fsync=True, component="memory", stage=self.stage,
            rank=self.rank, error=str(exc)[:300], bundle=bundle_path or "",
            live_bytes=snap["bytes"], live_buffers=snap["buffers"],
            peak_bytes=self.watermark(),
            **{k: str(v) for k, v in ctx.items()},
        )
        logger.error(
            "OOM at stage=%s rank=%d: %s (forensics: %s)",
            self.stage, self.rank, str(exc)[:200], bundle_path or "flight only",
        )
        return bundle_path

    def close(self) -> None:
        """Score the stage (plan accuracy) and release the gauge
        closures — a restaged stage must not pin this one alive."""
        try:
            self.plan_accuracy()
        except Exception:  # noqa: BLE001 — closing telemetry never raises
            pass
        self._binding.release()
