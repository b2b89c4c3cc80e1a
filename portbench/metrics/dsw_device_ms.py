"""Device ms per step of the launches that end in a dsw_* wrapper (their
leading fvtp2d_tile and hydro_columns stages included)."""
from portbench.devtrace import wrapper_times


def read(rec):
    us = sum(t for w, t in wrapper_times(rec.events).items()
             if w.startswith("dsw_"))
    return us / 1e3 / rec.steps if us else None
