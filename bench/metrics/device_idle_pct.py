"""Share of the traced window in which no operation ran on the device (the
union of the operations' intervals), in percent."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t and t.window_s > 0 else None
