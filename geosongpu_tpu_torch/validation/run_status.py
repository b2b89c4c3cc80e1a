"""Run reproducibility record (the port's form of
geosongpu_tpu/validation/run_status.py): the repository's SHA, its dirty
flag, the configuration's hash (the original's for the same dict) and the
torch, CUDA and device the run used, comparable across runs."""
from __future__ import annotations

import hashlib
import json
import subprocess
from dataclasses import asdict, dataclass
from typing import Optional


@dataclass
class RunStatus:
    git_sha: str
    git_dirty: bool
    config_hash: str
    torch_version: str
    cuda_version: str
    device: str

    def same_code(self, other: "RunStatus") -> bool:
        return (self.git_sha == other.git_sha
                and not self.git_dirty and not other.git_dirty)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "RunStatus":
        return cls(**json.loads(s))


def _git(args, cwd=None) -> str:
    """git's output, or "" where git is missing or the directory is no
    repository (a copy of the tree)."""
    try:
        return subprocess.run(["git"] + args, cwd=cwd, capture_output=True,
                              text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def config_hash(config: Optional[dict]) -> str:
    return hashlib.sha256(
        json.dumps(config or {}, sort_keys=True).encode()).hexdigest()[:16]


def capture(config: Optional[dict] = None, repo_dir: str = ".",
            device="cuda") -> RunStatus:
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        where = f"cuda:{index} {torch.cuda.get_device_name(index)}"
    else:
        where = str(device)
    return RunStatus(
        git_sha=_git(["rev-parse", "HEAD"], repo_dir) or "unknown",
        git_dirty=bool(_git(["status", "--porcelain"], repo_dir)),
        config_hash=config_hash(config),
        torch_version=torch.__version__,
        cuda_version=str(torch.version.cuda),
        device=where,
    )
