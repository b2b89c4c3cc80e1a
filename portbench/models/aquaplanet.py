"""The aquaplanet model: the program's
`geosongpu_tpu_torch/models/aquaplanet.py` and the plain reference's
(portbench/reference/models/aquaplanet.py), each built from the
configuration file's `dycore` fields.  The hydrostatic dycore advects
vapour, cloud liquid and rain (q[..., 0..2] = qv, ql, qr), and the moist
physics chain (fill, surface fluxes, shallow convection, microphysics,
Held-Suarez relaxation) is the step's forcing.

The initial state is the model's own `init(perturb, seed)` (potential
temperature noise of the traffic's `perturb` K, 60% relative humidity
below sigma 0.5), moistened from the seed on the device: qv times a
factor uniform in [1, 1 + qv_boost), ql uniform in [0, ql_max) and qr in
[0, qr_max), three draws in that order from one generator of the state's
device.  With the `moist` traffic's 0.9, 3e-4 and 1e-4 the vapour reaches
1.14 of saturation and cloud and rain are present from the first step,
so that condensation, autoconversion, sedimentation and evaporation all
act at once; from the model's own start no cloud forms for 13 steps.

The counted calls of a step are the fused dycore's (portbench/counts.py)
and the chain's three column kernels (aquaplanet_columns.py beside this
file).
"""
from __future__ import annotations

import dataclasses

import torch

from portbench import counts, drive
from portbench.models import aquaplanet_columns

FIELDS = ("u", "v", "pt", "delp", "q", "ps")


def build_program(config: dict, device):
    """The program's model of the configuration file `config`."""
    from geosongpu_tpu_torch.core.config import DycoreConfig
    from geosongpu_tpu_torch.models.aquaplanet import build_model

    return build_model(DycoreConfig(**config["dycore"]), device)


def moisten(state, traffic: dict, seed: int):
    """`state` with its vapour raised and cloud liquid and rain drawn from
    `seed` on the state's device."""
    q = state.q.clone()
    gen = torch.Generator(device=q.device)
    gen.manual_seed(drive.seed_of(seed))

    def draw():
        return torch.rand(q.shape[:-1], generator=gen, device=q.device,
                          dtype=torch.float32)

    q[..., 0] *= 1.0 + traffic["qv_boost"] * draw()
    q[..., 1] = traffic["ql_max"] * draw()
    q[..., 2] = traffic["qr_max"] * draw()
    return dataclasses.replace(state, q=q)


def initial_state(model, traffic: dict, seed: int):
    state = model.init(perturb=traffic["perturb"], seed=drive.seed_of(seed))
    return moisten(state, traffic, seed)


def build_reference(config: dict, device):
    from portbench.reference.core.config import DycoreConfig
    from portbench.reference.models.aquaplanet import build_model

    return build_model(DycoreConfig(**config["dycore"]), device)


def reference_initial(ref, traffic: dict, seed: int):
    """The reference's initial state, drawn from the seed as the program's
    is by `initial_state`."""
    state = ref.init(perturb=traffic["perturb"], seed=drive.seed_of(seed))
    return moisten(state, traffic, seed)


def compared_fields(config: dict) -> tuple:
    return FIELDS


def step_calls(config: dict) -> list:
    """The counted kernel calls of one step: the fused dycore's and the
    physics chain's column kernels."""
    return (counts.step_calls(config["dycore"])
            + aquaplanet_columns.step_calls(config["dycore"]))
