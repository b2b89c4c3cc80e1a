"""GPU job-launch configuration (the port's counterpart of
geosongpu_tpu/harness/launcher.py).

One launch description, hosts x GPUs per host plus environment, with the
reference's canned layouts.  One process drives one GPU, so a run of more
than one process gets torch.distributed's variables per rank
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK).  The wrapper
script brackets the payload with the port's hardware sampler on rank 0, as
the reference brackets it with its own.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ..hws import constants as hws
from .shell import ShellScript

HWS_CLI = "python -m geosongpu_tpu_torch.hws.cli"


@dataclass
class GPUJobConfig:
    """One launch description: hosts x GPUs per host + env."""

    hosts: int = 1
    gpus_per_host: int = 8
    coordinator: str = "localhost:29500"   # MASTER_ADDR:MASTER_PORT
    env: Dict[str, str] = field(default_factory=dict)
    hardware_sampling: bool = False

    # -- canned layouts -------------------------------------------------
    @classmethod
    def one_gpu(cls) -> "GPUJobConfig":
        return cls(hosts=1, gpus_per_host=1)

    @classmethod
    def one_node_8gpu(cls) -> "GPUJobConfig":
        return cls(hosts=1, gpus_per_host=8)

    @classmethod
    def two_nodes_4gpu(cls) -> "GPUJobConfig":
        return cls(hosts=2, gpus_per_host=4)

    @property
    def total_gpus(self) -> int:
        return self.hosts * self.gpus_per_host

    def launch_env(self, rank: int) -> Dict[str, str]:
        env = dict(self.env)
        if self.total_gpus > 1:
            addr, port = self.coordinator.rsplit(":", 1)
            env.update({
                "MASTER_ADDR": addr,
                "MASTER_PORT": port,
                "WORLD_SIZE": str(self.total_gpus),
                "RANK": str(rank),
                "LOCAL_RANK": str(rank % self.gpus_per_host),
            })
        return env

    def wrapper_script(self, payload: List[str], name: str = "gpu_run",
                       wd: str = ".") -> ShellScript:
        """Bracket the payload with the hardware sampler on rank 0: the
        server in the background (its socket under the script's working
        directory), `client start` once it listens, the payload, then
        `client dump` and `client stop`.  The server is killed when the
        script exits early."""
        sock = f"{hws.SOCKET_DIRECTORY}/{hws.SOCKET_FILENAME}"
        cmds: List[str] = []
        if self.hardware_sampling:
            cmds += [
                'if [ "${RANK:-0}" = "0" ]; then',
                f"  {HWS_CLI} server --dump_dir . --device cuda &",
                "  HWS_PID=$!",
                "  trap 'kill ${HWS_PID} 2>/dev/null || true' EXIT",
                f"  until [ -S {sock} ]; do kill -0 ${{HWS_PID}}; "
                "sleep 0.2; done",
                f"  {HWS_CLI} client start",
                "fi",
            ]
        cmds += list(payload)
        if self.hardware_sampling:
            cmds += [
                'if [ "${RANK:-0}" = "0" ]; then',
                f"  {HWS_CLI} client dump",
                f"  {HWS_CLI} client stop",
                "  wait ${HWS_PID} 2>/dev/null || true",
                "fi",
            ]
        script = ShellScript(name, wd)
        script.write(cmds, exports=self.launch_env(0))
        return script
