"""Simulated years per wall-clock day (CPMIP's SYPD): every step the
window completed times the model's dt, over the window's seconds from the
stamp before its first step to the end stamp of its last, per 365 days."""


def read(rec):
    if rec.steps == 0 or rec.window_s <= 0.0:
        return None
    return rec.steps * rec.dt / rec.window_s / 365.0
