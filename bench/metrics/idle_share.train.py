"""The device's idle share of the traced segment, in percent: one less
the seconds in which a device op ran (the union of their intervals in the
profiler's trace) over the segment's wall seconds."""


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
