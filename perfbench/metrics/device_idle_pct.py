"""device: the share of the profiled span of the cell's units (walk
cycles, fit steps, matrix calls) in which no kernel, copy or fill runs on
the card. The reader of every ``device_idle_pct.<traffic>``; each moves its
cell's rate or time a unit."""


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0.0 or tr.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
