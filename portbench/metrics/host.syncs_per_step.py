"""Host synchronisations per step: scalar reads in the traced steps."""


def read(ctx):
    return ctx["trace"]["syncs"] / ctx["k"]
