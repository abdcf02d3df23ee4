"""Hot-standby worker shells: pre-paid process start for elastic restages.

The port of ``edl_tpu/launch/standby.py``: the same pool, activation
message and fallback chain, with a torch shell child. A stop-resume
restage of the port pays a worker's cold start before its first step —
the interpreter, ``torch`` and the package's imports, the kernel
libraries' load — and that is the part a shell pays ahead of time.

A :class:`StandbyPool` keeps ``nproc`` *standby shells* per pod: spawned
worker processes (own session, PDEATHSIG armed) that have already
imported ``numpy``, ``torch`` and ``edl_tpu_torch.{models, parallel,
train, ops}`` and loaded the kernel libraries that resolve without
``nvcc`` (``ops/_build.preload``: ``dlopen`` only, no CUDA call, so no
CUDA context beside a live stage), and then BLOCK on stdin waiting for
an activation message. When the launcher adopts a stage it activates a
standby instead of cold-spawning: one json line carries the complete
worker env, script path, args and log path; the shell replaces its
environment, redirects stdout/stderr to the worker log, pulls the
compile-cache entries its peers published (``train/aot.pull_missing``,
overlapping the control plane's convergence) and ``runpy``-executes the
training script in-process, the script's dir first on ``sys.path``.

Eager device init: when the elastic window pins the world to ONE worker
(``max_nodes * nproc_per_node == 1``), or ``EDL_STANDBY_EAGER=1``, the
first standby also creates its CUDA context on the card at spawn, while
the control plane converges. Otherwise it must not: a shell waits beside
a live stage that owns the card, and which card a rank uses is decided
only at activation. Replacement standbys never eager-init.

The standby is a strict fallback chain: a dead/unusable standby (or an
env that changed between spawn and activation in a variable the shell
has already acted on) degrades to the normal cold spawn in
``start_local_workers`` — activation can never be worse than not having
a pool.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Sequence

from edl_tpu_torch.utils.log import get_logger

logger = get_logger("launch.standby")

# the shell acts on these before activation (the visible cards of an
# eager init, the kernel-library dir it resolved and loaded from); an
# activation that disagrees would run the worker on the wrong ones
_IMPORT_TIME_VARS = ("CUDA_VISIBLE_DEVICES", "EDL_COMPILE_CACHE_DIR")


def standby_enabled(cli_flag: bool = False) -> bool:
    env = os.environ.get("EDL_STANDBY", "")
    if env in ("0", "off"):
        return False
    return cli_flag or env == "1"


class StandbyPool:
    """Per-pod pool of pre-imported worker shells.

    ``spawn_env`` is the complete base env for the shells (the launcher's
    env after proxy stripping, plus the job's extra worker env) —
    activation replaces it wholesale with the stage's worker env, but the
    variables the shell acts on before activation must already be right
    at spawn.
    """

    def __init__(
        self,
        spawn_env: Dict[str, str],
        count: int = 1,
        eager: bool = False,
    ) -> None:
        self.spawn_env = dict(spawn_env)
        self.count = max(1, count)
        self._eager_budget = self.count if eager else 0
        self._mu = threading.Lock()
        self._idle: List[subprocess.Popen] = []
        self._stopped = False
        self._respawn_timer: Optional[threading.Timer] = None
        # replacements wait out the fresh workers' own startup (an
        # immediate respawn's imports contend with the worker's first
        # step). Unlike the JAX pool's they are not niced: an activated
        # shell IS the worker for its whole life, and an unprivileged
        # process cannot lower its nice value again
        self.respawn_delay = float(
            os.environ.get("EDL_STANDBY_RESPAWN_DELAY", "30")
        )
        self.ensure()

    # -- spawning ----------------------------------------------------------

    def _spawn_one(self) -> Optional[subprocess.Popen]:
        env = dict(self.spawn_env)
        if self._eager_budget > 0:
            env["EDL_STANDBY_EAGER"] = "1"
            self._eager_budget -= 1
        else:
            env.pop("EDL_STANDBY_EAGER", None)
        cmd = [sys.executable, "-u", "-m", "edl_tpu_torch.launch.standby"]
        try:
            proc = subprocess.Popen(  # edl: blocking-ok(fork+exec is ms-scale and top-ups are restage-rare; take() waits at most one pool refill — same budget as launch/process.py)
                cmd,
                env=env,
                stdin=subprocess.PIPE,
                start_new_session=True,
            )
        except OSError as exc:
            logger.warning("standby spawn failed: %s", exc)
            return None
        logger.info(
            "standby shell pid=%d spawned%s",
            proc.pid,
            " (eager backend init)" if env.get("EDL_STANDBY_EAGER") else "",
        )
        return proc

    def ensure(self) -> None:
        """Top the pool back up to ``count`` live shells."""
        with self._mu:
            if self._stopped:
                return
            self._idle = [p for p in self._idle if p.poll() is None]
            while len(self._idle) < self.count:
                proc = self._spawn_one()
                if proc is None:
                    break
                self._idle.append(proc)

    def ensure_later(self) -> None:
        """Schedule a top-up after ``respawn_delay`` seconds —
        called right after activation, when an immediate respawn would
        contend with the just-activated workers' startup."""
        with self._mu:
            if self._stopped:
                return
            if self._respawn_timer is not None:
                self._respawn_timer.cancel()
            self._respawn_timer = threading.Timer(
                self.respawn_delay, self.ensure
            )
            self._respawn_timer.daemon = True
            self._respawn_timer.start()

    # -- activation --------------------------------------------------------

    def _env_compatible(self, env: Dict[str, str]) -> bool:
        # unset and empty differ: CUDA_VISIBLE_DEVICES="" hides every card
        for var in _IMPORT_TIME_VARS:
            if self.spawn_env.get(var) != env.get(var):
                logger.info(
                    "standby declined: %s changed between spawn (%r) and "
                    "activation (%r)",
                    var, self.spawn_env.get(var), env.get(var),
                )
                return False
        return True

    def activate(
        self,
        env: Dict[str, str],
        training_script: str,
        training_args: Sequence[str],
        log_path: str = "",
    ) -> Optional[subprocess.Popen]:
        """Turn one standby shell into THE worker; None = use a cold spawn.

        The returned Popen is the worker process (same pid, same session,
        PDEATHSIG already armed); its exit code is the training script's.
        """
        if not self._env_compatible(env):
            return None
        with self._mu:
            while self._idle:
                proc = self._idle.pop(0)
                if proc.poll() is not None:
                    continue
                msg = json.dumps({
                    "env": dict(env),
                    "script": training_script,
                    "args": list(training_args),
                    "log_path": log_path,
                })
                try:
                    proc.stdin.write(msg.encode() + b"\n")
                    proc.stdin.flush()
                    proc.stdin.close()
                except (OSError, ValueError):
                    logger.warning(
                        "standby pid=%d unusable at activation; trying next",
                        proc.pid,
                    )
                    try:
                        proc.kill()
                    except OSError:
                        pass
                    continue
                logger.info(
                    "standby pid=%d activated as worker rank=%s",
                    proc.pid, env.get("EDL_WORKER_RANK", "?"),
                )
                return proc
        return None

    def stop(self) -> None:
        with self._mu:
            self._stopped = True
            if self._respawn_timer is not None:
                self._respawn_timer.cancel()
                self._respawn_timer = None
            procs, self._idle = self._idle, []
        for proc in procs:
            try:
                proc.kill()
            except OSError:
                pass
        for proc in procs:
            try:
                proc.wait(timeout=5.0)
            except (subprocess.TimeoutExpired, OSError):
                pass


# -- the shell child (python -m edl_tpu_torch.launch.standby) ---------------


def _child_main() -> None:
    # PDEATHSIG first: the shell must die with its launcher exactly like a
    # cold-spawned worker (worker_command's bootstrap arms the same flag)
    try:
        import ctypes
        import signal as _signal

        ctypes.CDLL("libc.so.6", use_errno=True).prctl(
            1, int(_signal.SIGKILL), 0, 0, 0
        )
    except Exception:
        pass  # non-glibc: orphan cleanup degrades to lease TTL

    # the pre-payment: heavy imports and the kernel libraries' load now,
    # while the control plane converges. No CUDA call unless eager (a
    # live stage may own the card): dlopen registers a library's kernels
    # without creating a context.
    import numpy  # noqa: F401

    try:
        import torch

        import edl_tpu_torch.models  # noqa: F401
        import edl_tpu_torch.ops  # noqa: F401
        import edl_tpu_torch.parallel  # noqa: F401
        import edl_tpu_torch.train  # noqa: F401
        from edl_tpu_torch.ops import _build

        try:
            loaded = _build.preload()
            logger.info("standby preloaded kernel libraries: %s",
                        ", ".join(loaded) or "none")
        except Exception as exc:  # noqa: BLE001 — first use loads them
            logger.warning("standby kernel preload failed: %s", exc)
        if os.environ.get("EDL_STANDBY_EAGER") == "1":
            # single-worker window: claim the freed card before the stage
            # publishes (see module docstring for why this is gated)
            try:
                torch.zeros(1, device="cuda")
                logger.info("standby eager device init: %s",
                            torch.cuda.get_device_name(0))
            except Exception as exc:
                logger.warning("standby eager init failed: %s", exc)
    except ImportError as exc:
        logger.warning("standby pre-import incomplete: %s", exc)

    line = sys.stdin.buffer.readline()
    if not line.strip():
        sys.exit(0)  # launcher closed the pipe without activating: retire
    spec = json.loads(line)

    env = spec.get("env", {})
    os.environ.clear()
    os.environ.update(env)
    log_path = spec.get("log_path", "")
    if log_path:
        fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(fd, 1)
        os.dup2(fd, 2)
        os.close(fd)

    # cache exchange (train/aot.py): pull the kernel libraries peers
    # already built, HERE — the activation window overlaps the control
    # plane's own convergence, so the transfer is free wall-clock.
    # EDL_CACHE_PULLED tells train.init() not to pull a second time.
    # Best-effort: any failure degrades to init()'s own bounded pull / a
    # normal build.
    if (
        os.environ.get("EDL_COMPILE_CACHE_DIR")
        and os.environ.get("EDL_STORE_ENDPOINT")
        and os.environ.get("EDL_CACHE_EXCHANGE", "1") != "0"
    ):
        try:
            from edl_tpu_torch.train.aot import pull_missing

            stats = pull_missing(
                os.environ["EDL_COMPILE_CACHE_DIR"],
                endpoint=os.environ["EDL_STORE_ENDPOINT"],
                job_id=os.environ.get("EDL_JOB_ID", ""),
                own_pod=os.environ.get("EDL_POD_ID", ""),
            )
            # dedupe init()'s pull only when this one actually reached a
            # peer: activating before any manifest exists returns peers=0,
            # and suppressing the later bounded pull would forfeit entries
            # published moments later
            if stats.get("peers") or stats.get("pulled"):
                os.environ["EDL_CACHE_PULLED"] = "1"
        except Exception as exc:  # noqa: BLE001
            logger.warning("standby cache pull failed: %s", exc)

    import runpy

    script = spec["script"]
    sys.argv = [script] + list(spec.get("args", []))
    # `python script.py` puts the script's directory at sys.path[0];
    # run_path does not — match it, or script-local imports would work
    # cold-spawned but break through the standby fast path
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
    runpy.run_path(script, run_name="__main__")


if __name__ == "__main__":
    _child_main()
