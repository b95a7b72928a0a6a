"""Device kernel launches per step in the traced steps."""


def read(ctx):
    return ctx["trace"]["launches"] / ctx["k"] if ctx["trace"]["launches"] \
        else None
