"""Managed-job submission and state polling (the port's counterpart of
geosongpu_tpu/harness/jobqueue.py).

The same submit -> poll -> terminal-state contract over pluggable
backends, with the reference's five states (PENDING, RUNNING, COMPLETED,
FAILED, CANCELLED):

* ``LocalBackend`` - a detached process and pid polling (the single-host
  path over harness/shell.py), the reference's own, with its ``.ok``
  sentinel and WNOHANG reap.
* ``SlurmBackend`` - a GPU cluster's scheduler, the one the GEOS GPU CI
  submits to: ``sbatch --parsable`` to submit, ``sacct -j ID -n -X -o
  State`` to poll, ``scancel`` to cancel.  Its command runner is injected,
  so the control flow is tested without a cluster.

The reference's ``QueuedResourceBackend`` provisions Cloud TPU queued
resources through gcloud; a GPU job has no such step, so it has no
counterpart here.
"""
from __future__ import annotations

import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .progress import Progress


class JobState:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"

    TERMINAL = (COMPLETED, FAILED, CANCELLED)


@dataclass
class JobHandle:
    job_id: str
    backend: str
    meta: Dict = field(default_factory=dict)


class JobQueueError(RuntimeError):
    pass


# --------------------------------------------------------------------------
# local backend (detach + pid poll; the single-host path)
# --------------------------------------------------------------------------

class LocalBackend:
    name = "local"

    def __init__(self, working_directory: str = "."):
        self.wd = working_directory
        self._final: Dict[str, str] = {}

    def submit(self, commands: List[str], job_name: str = "job"
               ) -> JobHandle:
        from .shell import ShellScript

        sh = ShellScript(job_name, self.wd)
        # success sentinel: ShellScript runs `set -e`, so the last line
        # only executes if every command succeeded - the fallback signal
        # when something else (a test harness, a SIGCHLD consumer) reaps
        # the pid before our WNOHANG poll sees the status
        ok_file = os.path.join(self.wd, f".{job_name}.ok")
        if os.path.exists(ok_file):
            os.unlink(ok_file)
        sh.write(list(commands) + [f"touch {ok_file}"])
        pid = sh.execute_detached(
            log_path=os.path.join(self.wd, f"{job_name}.log"))
        return JobHandle(job_id=str(pid), backend=self.name,
                         meta={"ok_file": ok_file})

    def state(self, h: JobHandle) -> str:
        if h.job_id in self._final:
            return self._final[h.job_id]
        pid = int(h.job_id)
        try:
            # we are the parent of the detached script: a WNOHANG reap
            # both detects exit AND returns the exit status (zombies
            # would otherwise still answer kill(pid, 0))
            done, status = os.waitpid(pid, os.WNOHANG)
        except ChildProcessError:
            # already reaped elsewhere: fall back to the success sentinel
            ok = os.path.exists(h.meta.get("ok_file", ""))
            self._final[h.job_id] = (JobState.COMPLETED if ok
                                     else JobState.FAILED)
            return self._final[h.job_id]
        if done == 0:
            return JobState.RUNNING
        ok = (os.waitstatus_to_exitcode(status) == 0
              or os.path.exists(h.meta.get("ok_file", "")))
        self._final[h.job_id] = (JobState.COMPLETED if ok
                                 else JobState.FAILED)
        return self._final[h.job_id]

    def cancel(self, h: JobHandle) -> None:
        if h.job_id in self._final:
            return
        try:
            # the detached script runs in its own session (pid == pgid):
            # signal the exact group we created, never by pattern
            os.killpg(int(h.job_id), 15)
        except ProcessLookupError:
            pass


# --------------------------------------------------------------------------
# SLURM backend
# --------------------------------------------------------------------------

# sacct states -> job states (a state may carry a suffix: "CANCELLED by 0")
_SLURM_STATES = {
    "PENDING": JobState.PENDING,
    "CONFIGURING": JobState.PENDING,
    "REQUEUED": JobState.PENDING,
    "RESV_DEL_HOLD": JobState.PENDING,
    "REQUEUE_HOLD": JobState.PENDING,
    "REQUEUE_FED": JobState.PENDING,
    "RUNNING": JobState.RUNNING,
    "COMPLETING": JobState.RUNNING,
    "SUSPENDED": JobState.RUNNING,
    "RESIZING": JobState.RUNNING,
    "STAGE_OUT": JobState.RUNNING,
    "SIGNALING": JobState.RUNNING,
    "COMPLETED": JobState.COMPLETED,
    "FAILED": JobState.FAILED,
    "TIMEOUT": JobState.FAILED,
    "OUT_OF_MEMORY": JobState.FAILED,
    "NODE_FAIL": JobState.FAILED,
    "BOOT_FAIL": JobState.FAILED,
    "DEADLINE": JobState.FAILED,
    "PREEMPTED": JobState.FAILED,
    "REVOKED": JobState.CANCELLED,
    "CANCELLED": JobState.CANCELLED,
}


def _default_runner(cmd: List[str]) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise JobQueueError(f"{' '.join(cmd)} failed: {out.stderr[-500:]}")
    return out.stdout


class SlurmBackend:
    """SLURM batch submission.

    runner: callable(cmd list) -> stdout, raising JobQueueError on a
    failed command; injected for tests, the default runs the command."""

    name = "slurm"

    def __init__(self, working_directory: str = ".",
                 sbatch_args: Optional[List[str]] = None,
                 runner: Optional[Callable[[List[str]], str]] = None):
        self.wd = working_directory
        self.sbatch_args = list(sbatch_args or [])
        self.runner = runner or _default_runner

    def submit(self, commands: List[str], job_name: str = "job"
               ) -> JobHandle:
        from .shell import ShellScript

        script = ShellScript(job_name, self.wd).write(list(commands))
        out = self.runner(
            ["sbatch", "--parsable", f"--job-name={job_name}",
             f"--output={os.path.join(self.wd, job_name)}.log",
             *self.sbatch_args, script.path])
        # --parsable prints "jobid" or "jobid;cluster"
        job_id = out.strip().split(";")[0]
        if not job_id.isdigit():
            raise JobQueueError(f"sbatch gave no job id: {out!r}")
        return JobHandle(job_id=job_id, backend=self.name,
                         meta={"script": script.path})

    def state(self, h: JobHandle) -> str:
        out = self.runner(["sacct", "-j", h.job_id, "-n", "-X",
                           "-o", "State"])
        lines = out.split()
        if not lines:
            # accounting has not seen the job yet
            return JobState.PENDING
        raw = lines[0].rstrip("+")
        return _SLURM_STATES.get(raw, JobState.PENDING)

    def cancel(self, h: JobHandle) -> None:
        self.runner(["scancel", h.job_id])


# --------------------------------------------------------------------------
# the poll loop (the reference's sacct loop)
# --------------------------------------------------------------------------

def wait_for_job(backend, handle: JobHandle, poll_s: float = 10.0,
                 timeout_s: Optional[float] = None,
                 progress_every: int = 6) -> str:
    """Poll until a terminal state; returns it.  Raises JobQueueError on
    timeout (after cancelling), mirroring the reference's behavior of
    surfacing stuck SLURM jobs rather than hanging the pipeline."""
    t0 = time.monotonic()
    i = 0
    while True:
        st = backend.state(handle)
        if st in JobState.TERMINAL:
            return st
        if timeout_s is not None and time.monotonic() - t0 > timeout_s:
            backend.cancel(handle)
            raise JobQueueError(
                f"job {handle.job_id} timed out after {timeout_s}s "
                f"(last state {st})")
        if i % progress_every == 0:
            Progress.log(f"job {handle.job_id}: {st} "
                         f"({time.monotonic() - t0:.0f}s)")
        i += 1
        time.sleep(poll_s)
