"""The Held-Suarez model, hydrostatic or nonhydrostatic as the
configuration's `dycore.hydrostatic` says: the program's
`geosongpu_tpu_torch/models/held_suarez.py` and the plain reference's copy
of it (portbench/reference/models/held_suarez.py), each built from the
configuration file's `dycore` fields.

The initial state is the model's own `init(perturb, seed)` (potential
temperature noise of the traffic's `perturb` K), with each tracer drawn
uniform in [0, tracer_max) from the seed on the device, so that the tracer
transport moves a field that is not constant.  At the cells' size the
tracer moves by more than the check's CHANGE_FLOOR from the first step
(1.4e-4 of its size, 7e-4 by the fifteenth), so a step that skips the
tracer transport reads 0.7 to 1 in q; at c12 it moves by 2e-7 and would
not.

A model file gives the six functions below; portbench/spec.py finds it by
the configuration's `model` key, and portbench/run.py, drive.py and
compare.py reach the model only through them.
"""
from __future__ import annotations

import dataclasses

import torch

from portbench import counts, drive

FIELDS = ("u", "v", "pt", "delp", "q", "ps")
NH_FIELDS = ("w", "delz")


def build_program(config: dict, device):
    """The program's model of the configuration file `config`."""
    from geosongpu_tpu_torch.core.config import DycoreConfig
    from geosongpu_tpu_torch.models.held_suarez import build_model

    return build_model(DycoreConfig(**config["dycore"]), device)


def initial_tracers(shape, traffic: dict, seed: int, device) -> torch.Tensor:
    """The tracers of the initial state: uniform in [0, tracer_max), from a
    generator of `device` seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(drive.seed_of(seed))
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32) * traffic["tracer_max"]


def initial_state(model, traffic: dict, seed: int):
    state = model.init(perturb=traffic["perturb"], seed=drive.seed_of(seed))
    return dataclasses.replace(state, q=initial_tracers(
        state.q.shape, traffic, seed, state.q.device))


def build_reference(config: dict, device):
    from portbench.reference.core.config import DycoreConfig
    from portbench.reference.models.held_suarez import build_model

    return build_model(DycoreConfig(**config["dycore"]), device)


def reference_initial(ref, traffic: dict, seed: int):
    """The reference's initial state, drawn from the seed as the program's
    is by `initial_state`."""
    state = ref.init(perturb=traffic["perturb"], seed=drive.seed_of(seed))
    return dataclasses.replace(state, q=initial_tracers(
        state.q.shape, traffic, seed, state.q.device))


def compared_fields(config: dict) -> tuple:
    return FIELDS + (() if config["dycore"]["hydrostatic"] else NH_FIELDS)


def step_calls(config: dict) -> list:
    """The counted kernel calls of one step (portbench/counts.py): the
    fused dycore's, as the forcing and symmetrization are glue."""
    return counts.step_calls(config["dycore"])
