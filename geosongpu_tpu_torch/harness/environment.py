"""Cross-task key/value vault with OS-environment fallback and the typed
experiment config (geosongpu_tpu/harness/environment.py)."""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

from ..core.config import ExperimentConfig


class Environment:
    def __init__(self, experiment_name: str, experiment_action: str,
                 artifact_directory: str,
                 config: Optional[ExperimentConfig] = None):
        self.experiment_name = experiment_name
        self.experiment_action = experiment_action
        self.artifact_directory = artifact_directory
        self.config = config
        self.metadata: Dict[str, Any] = {}
        self._vault: Dict[str, Any] = {}

    def set(self, key: str, value: Any) -> None:
        self._vault[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._vault:
            return self._vault[key]
        return os.environ.get(key, default)

    def exists(self, key: str) -> bool:
        return key in self._vault or key in os.environ

    @property
    def CI_WORKSPACE(self) -> str:
        ws = self.get("CI_WORKSPACE")
        if ws is None:
            raise RuntimeError("CI_WORKSPACE is not set")
        return ws
