"""Task framework: the task lifecycle and experiment dispatch
(geosongpu_tpu/harness/task.py).

The same actions, TaskBase run/check lifecycle, experiment lookup and
sequential executor that raises on a failed check.  Two differences: the
experiment table is JSON (`data/experiments.json`, read with the standard
library, so the harness needs no yaml package) and so is the provenance
record `ci_metadata`; and `dispatch` takes the torch device the tasks run
their models on, the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import datetime
import json
import os
from typing import Any, Dict, Optional

from ..core.config import ExperimentConfig
from .environment import Environment
from .exceptions import CICheckException
from .progress import Progress
from .registry import Registry


class PipelineAction:
    """The pipeline's actions."""

    All = "All"
    Validation = "Validation"
    Benchmark = "Benchmark"

    CHOICES = (All, Validation, Benchmark)


class TaskBase:
    """One unit of pipeline work: run_action() then check() gate."""

    step: int = 0

    def _prelude(self, config: Dict[str, Any], env: Environment) -> None:
        env.metadata["timestamp"] = str(datetime.datetime.now())
        env.metadata["config"] = {"name": env.experiment_name,
                                  "value": _jsonable(config)}
        env.metadata["action"] = env.experiment_action

    def _dump_metadata(self, env: Environment) -> None:
        os.makedirs(env.CI_WORKSPACE, exist_ok=True)
        path = os.path.join(env.CI_WORKSPACE, "ci_metadata")
        with open(path, "w") as f:
            json.dump(env.metadata, f, indent=2)

    def run(self, config: Dict[str, Any], env: Environment) -> None:
        self._prelude(config, env)
        with Progress(f"{self.__class__.__name__}.run_action"):
            self.run_action(config, env)
        self._dump_metadata(env)

    # -- to implement ---------------------------------------------------
    def run_action(self, config: Dict[str, Any], env: Environment) -> None:
        raise NotImplementedError

    def check(self, config: Dict[str, Any], env: Environment) -> bool:
        raise NotImplementedError


def _jsonable(x):
    try:
        json.dumps(x)
        return x
    except TypeError:
        return str(x)


def _experiments_path() -> str:
    return os.path.join(os.path.dirname(__file__), "data", "experiments.json")


def load_experiments() -> Dict[str, Any]:
    with open(_experiments_path()) as f:
        return json.load(f)


def get_config(experiment_name: str) -> Dict[str, Any]:
    experiments = load_experiments()
    if experiment_name not in experiments:
        raise KeyError(
            f"Unknown experiment '{experiment_name}'; "
            f"known: {sorted(experiments)}")
    return experiments[experiment_name]


def dispatch(experiment_name: str, experiment_action: str = PipelineAction.All,
             artifact_directory: str = ".", setup_only: bool = False,
             workspace: Optional[str] = None,
             device: str = "cuda",
             stacked_ranks: bool = False) -> Environment:
    """Resolve the experiment, build the env, run its task list in order,
    and raise CICheckException if any check fails.  device: where the
    tasks run their models (env "device").  stacked_ranks: run a declared
    mesh with all its ranks stacked in this process on `device` (env
    "stacked_ranks"; parallel/comm.StackedGroup)."""
    raw = get_config(experiment_name)
    exp_cfg = None
    if "experiment" in raw:
        exp_cfg = ExperimentConfig.from_dict(
            {"name": experiment_name, **raw["experiment"]})

    env = Environment(
        experiment_name=experiment_name,
        experiment_action=experiment_action,
        artifact_directory=os.path.abspath(artifact_directory),
        config=exp_cfg,
    )
    if workspace:
        env.set("CI_WORKSPACE", os.path.abspath(workspace))
    env.set("device", device)
    env.set("stacked_ranks", bool(stacked_ranks))

    # import for side-effect: task classes self-register
    from . import tasks  # noqa: F401

    for task_name in raw.get("tasks", []):
        task = Registry.get(task_name)()
        if setup_only:
            Progress.log(f"[setup-only] skipping {task_name}")
            continue
        task.run(raw, env)
        with Progress(f"{task_name}.check"):
            ok = task.check(raw, env)
        if not ok:
            raise CICheckException(
                f"Check for task {task_name} of experiment "
                f"{experiment_name} failed")
    return env
