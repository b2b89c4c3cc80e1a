"""Device ms a step of the aquaplanet chain's column kernels, by kernel
name: fill_q2_zero_columns, cup_gf_sh_points and
gfdl_microphysics_columns (portbench/models/aquaplanet_columns.py)."""
from portbench.models.aquaplanet_columns import device_us


def read(rec):
    us = sum(device_us(rec.events).values())
    return us / 1e3 / rec.steps if us else None
