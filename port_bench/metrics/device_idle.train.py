"""Device: the share of the traced sub-window (steps and an epoch end) in
which no kernel or copy ran on the device, in percent."""


def read(run):
    t = run.trace
    if not t.device or t.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)
