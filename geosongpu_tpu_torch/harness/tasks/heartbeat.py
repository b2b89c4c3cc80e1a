"""Heartbeat task: proves the dispatch->task->artifact loop works (the
port's copy of geosongpu_tpu/harness/tasks/heartbeat.py)."""
from __future__ import annotations

import os
import shutil

from ..environment import Environment
from ..registry import Registry
from ..task import TaskBase


@Registry.register
class Heartbeat(TaskBase):
    def run_action(self, config, env: Environment) -> None:
        # no-op: the lifecycle itself is the test
        pass

    def check(self, config, env: Environment) -> bool:
        ws = env.CI_WORKSPACE
        meta = os.path.join(ws, "ci_metadata")
        if not os.path.isfile(meta):
            return False
        os.makedirs(env.artifact_directory, exist_ok=True)
        shutil.copy(meta, os.path.join(env.artifact_directory, "ci_metadata"))
        return True
