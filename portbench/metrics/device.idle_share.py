"""Share of the untraced wall time of the traced steps in which the device
ran nothing: 1 - busy (the union of device intervals in the trace) / wall."""


def read(ctx):
    busy = ctx["trace"]["busy_s"]
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx["wall_s"])
