"""Fleet lifecycle: spawn, rolling restart, teardown (the JAX package's
``fleet/lifecycle.py``).

The :class:`FleetSupervisor` owns the worker subprocesses (the frontend
owns their sockets): it spawns ``python -m amgx_tpu_torch.fleet.worker``
with a shared registry directory and a shared
:class:`~amgx_tpu_torch.store.store.ArtifactStore` directory, waits for
the registry announce, and runs the drain-then-warm-boot rolling
restart:

    quiesce(slot)      the frontend stops routing new work to the slot
    drain over wire    the worker settles every admitted ticket and
                       exports hierarchies and sessions to the store
                       (``store/warmboot.py``)
    reap               the drained process exits; the supervisor joins it
    spawn replacement  same slot; it warm-boots from the same store
    attach             the frontend routes to it again; its first group
                       of a persisted fingerprint is a hierarchy-cache
                       hit (coarsen_calls == 0)

``kill(worker_id)`` (SIGKILL by default) is the chaos face: the
frontend's connection-loss path (breaker trip, requeue once) takes it
from there.  The spawned command is :attr:`FleetSupervisor.worker_cmd`
followed by the worker's flags.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Optional

from amgx_tpu_torch.fleet.registry import WorkerRegistry


class FleetSupervisor:
    """Spawns and reaps fleet worker subprocesses on this host.
    ``env`` is laid over this process's environment for every worker
    (``OMP_NUM_THREADS``, ``CUDA_VISIBLE_DEVICES``, ...); the worker's
    own flags (``--device``, ``--max-batch``) go in ``worker_args``."""

    # the worker entry point; the registry, id, slot and store flags
    # follow
    worker_cmd = (sys.executable, "-m", "amgx_tpu_torch.fleet.worker")

    def __init__(self, registry_dir: str, store_dir: Optional[str] = None,
                 *, env: Optional[dict] = None,
                 spawn_timeout_s: float = 120.0,
                 worker_args: Optional[list] = None):
        self.registry = WorkerRegistry(registry_dir)
        self.store_dir = store_dir
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.worker_args = list(worker_args or [])
        self._env = dict(os.environ)
        self._env.update(env or {})
        self._procs: dict = {}  # worker_id -> Popen
        self._spawn_seq = 0

    # -- spawning ------------------------------------------------------

    def spawn(self, slot: int, *, worker_id: Optional[str] = None,
              placement: Optional[str] = None,
              env: Optional[dict] = None, extra_args: Optional[list] = None):
        """Start one worker and block until it announces.  Returns
        its WorkerRecord (address included).  ``placement`` overrides
        ``AMGX_TPU_PLACEMENT`` for the child (the port's workers take
        ``single``; the multi-device specs wait for queue A.9 and fail
        the spawn)."""
        wid, proc = self._start(slot, worker_id=worker_id,
                                placement=placement, env=env,
                                extra_args=extra_args)
        return self._announced(wid, proc)

    def _start(self, slot, worker_id=None, placement=None, env=None,
               extra_args=None):
        self._spawn_seq += 1
        wid = worker_id or f"w{slot}-{self._spawn_seq}"
        cmd = [
            *self.worker_cmd,
            "--registry", self.registry.root,
            "--worker-id", wid,
            "--slot", str(slot),
        ]
        if self.store_dir:
            cmd += ["--store", str(self.store_dir)]
        cmd += self.worker_args + list(extra_args or [])
        child_env = dict(self._env)
        child_env.update(env or {})
        if placement is not None:
            child_env["AMGX_TPU_PLACEMENT"] = placement
        return wid, subprocess.Popen(cmd, env=child_env)

    def _announced(self, wid, proc):
        """Wait for ``wid``'s announce; a worker that exits first, or
        does not announce within ``spawn_timeout_s``, raises at once
        (and a late one is killed)."""
        deadline = time.monotonic() + self.spawn_timeout_s
        while True:
            rec = self.registry.lookup(wid)
            if rec is not None and rec.alive():
                self._procs[wid] = proc
                return rec
            rc = proc.poll()
            if rc is not None:
                raise RuntimeError(
                    f"fleet worker {wid!r} exited with code {rc} before "
                    "it announced")
            if time.monotonic() >= deadline:
                proc.kill()
                proc.wait()
                raise TimeoutError(
                    f"worker {wid!r} did not announce within "
                    f"{self.spawn_timeout_s}s")
            time.sleep(0.05)

    def launch(self, n: int, **spawn_kwargs) -> list:
        """Spawn ``n`` workers on slots 0..n-1, all started together,
        then wait for each announce."""
        started = [self._start(slot, **spawn_kwargs) for slot in range(n)]
        try:
            return [self._announced(wid, proc) for wid, proc in started]
        except BaseException:
            for _wid, proc in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            raise

    # -- teardown ------------------------------------------------------

    def kill(self, worker_id: str, sig: int = signal.SIGKILL) -> bool:
        """Chaos face: signal a worker (default SIGKILL — no drain,
        no goodbye; the frontend's loss path takes it from there)."""
        proc = self._procs.get(worker_id)
        if proc is None or proc.poll() is not None:
            return False
        proc.send_signal(sig)
        return True

    def reap(self, worker_id: str,
             timeout_s: float = 60.0) -> Optional[int]:
        """Join a worker process; returns its exit code (None when it
        was never spawned here)."""
        proc = self._procs.pop(worker_id, None)
        if proc is None:
            return None
        try:
            return proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            return proc.wait()
        finally:
            self.registry.withdraw(worker_id)

    def terminate_all(self, timeout_s: float = 30.0) -> None:
        for wid, proc in list(self._procs.items()):
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + timeout_s
        for wid in list(self._procs):
            left = max(deadline - time.monotonic(), 0.1)
            self.reap(wid, timeout_s=left)

    def live_workers(self) -> list:
        return [
            wid for wid, p in self._procs.items() if p.poll() is None
        ]

    # -- the rolling restart -------------------------------------------

    def rolling_restart(self, worker_id: str, frontend, *,
                        timeout_s: float = 60.0,
                        placement: Optional[str] = None) -> dict:
        """Replace one worker with zero lost tickets and zero
        re-setups.  Returns ``{"drain": <worker's drain report>,
        "exit_code": ..., "replacement": <new WorkerRecord>}``."""
        rec = self.registry.lookup(worker_id)
        if rec is None:
            raise ValueError(f"unknown worker {worker_id!r}")
        slot = rec.slot
        # 1. no NEW work routes to the slot; in-flight work finishes
        frontend.quiesce(slot)
        # 2. lossless handoff: settle everything, export to the store
        report = frontend.drain_worker(slot, timeout=timeout_s)
        # 3. the drained process exits; join it
        exit_code = self.reap(worker_id, timeout_s=timeout_s)
        frontend.detach(slot)
        # 4. replacement at the SAME slot warm-boots from the store
        new_rec = self.spawn(slot, placement=placement)
        frontend.attach(new_rec)
        return {
            "drain": report,
            "exit_code": exit_code,
            "replacement": new_rec,
        }


def launch_fleet(n: int, registry_dir: str,
                 store_dir: Optional[str] = None, *,
                 env: Optional[dict] = None,
                 worker_args: Optional[list] = None,
                 frontend_kwargs: Optional[dict] = None,
                 **spawn_kwargs) -> tuple:
    """Convenience bring-up: spawn ``n`` workers and a connected
    frontend.  Returns ``(supervisor, frontend)``."""
    from amgx_tpu_torch.fleet.frontend import FleetFrontend

    sup = FleetSupervisor(
        registry_dir, store_dir, env=env, worker_args=worker_args
    )
    records = sup.launch(n, **spawn_kwargs)
    front = FleetFrontend(**(frontend_kwargs or {}))
    for rec in records:
        front.attach(rec)
    return sup, front
