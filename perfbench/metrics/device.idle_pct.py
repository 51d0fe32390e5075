"""device.idle_pct: the share of the traced window (``lib/trace``) in
which no operation ran on the device: 100 x (1 - busy / window), busy
the union of the device's activity in the profiler's (CUPTI) trace."""


def read(rec):
    t = rec.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
