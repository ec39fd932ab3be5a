"""Share of the traced window in which nothing ran on the device:
1 - (union of the device's activity) / (the window), in percent."""


def read(run):
    t = run.traced and run.traced.trace
    if not t or not t.window_s or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
