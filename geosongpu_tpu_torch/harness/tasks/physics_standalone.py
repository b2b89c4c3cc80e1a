"""Physics standalone validation tasks
(geosongpu_tpu/harness/tasks/physics_standalone.py).

One task a kernel, registered under the original's class names: the
dual-build gate of physics/standalone_gate.py as a pipeline task.  Each
runs the kernel's primary (plain PyTorch) and its hand-written kernel (a
CUDA kernel on a card, the kernel's plain version on the CPU) over the
gate's five datasets on the dispatch's device, writes each pair to
`{kernel}_ds{i}.npz` (`ref_*` and `opt_*`), and its check requires every
variable within the gate's 0.01% relative RMS.  On the card these tasks
are the path of the four kernels no model runs (aer_activation,
moist_rad_coup, buoyancy, evap_subl_pdf).
"""
from __future__ import annotations

import os

import numpy as np

from ...physics import standalone_gate as gate
from ..environment import Environment
from ..exceptions import CICheckException
from ..progress import Progress
from ..registry import Registry
from ..task import TaskBase


class _PhysicsStandaloneBase(TaskBase):
    kernel: str = ""

    def run_action(self, config, env: Environment) -> None:
        device = env.get("device", "cuda")
        ws = env.CI_WORKSPACE
        os.makedirs(ws, exist_ok=True)
        results = []
        for i in range(gate.N_DATASETS):
            data = gate.datasets(1000 + i)
            ref = gate.run_kernel(self.kernel, data, device)
            opt = gate.run_kernel_fused(self.kernel, data, device)
            results.append((ref, opt))
            np.savez_compressed(
                os.path.join(ws, f"{self.kernel}_ds{i}.npz"),
                **{f"ref_{k}": v for k, v in ref.items()},
                **{f"opt_{k}": v for k, v in opt.items()})
        env.set(f"physics.{self.kernel}.results", results)

    def check(self, config, env: Environment) -> bool:
        results = env.get(f"physics.{self.kernel}.results")
        if not results:
            return False
        for i, (ref, opt) in enumerate(results):
            try:
                gate.check(ref, opt)
            except gate.GateMiss as e:
                raise CICheckException(
                    f"{self.kernel} dataset {i} {e}") from None
        Progress.log(f"{self.kernel}: {len(results)} datasets within "
                     f"{gate.REL_TOL:.0e}")
        return True


for _name in gate.KERNELS:
    globals()[_name] = Registry.register(
        type(_name, (_PhysicsStandaloneBase,), {"kernel": _name}))
