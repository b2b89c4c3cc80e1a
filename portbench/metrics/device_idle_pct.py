"""The share of the traced window in which no device operation ran: one
less the union of the device events' intervals over the span from the
first event's start to the last one's end."""


def read(rec):
    if rec.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
