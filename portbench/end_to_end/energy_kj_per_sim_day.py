"""The card's energy over the window (NVML's total-energy counter, read
before the first step and after the last), in kJ per simulated day."""


def read(rec):
    if rec.energy_j is None or rec.steps == 0:
        return None
    return rec.energy_j / 1e3 / (rec.steps * rec.dt / 86400.0)
