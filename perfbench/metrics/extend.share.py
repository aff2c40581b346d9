"""Share of the window under the program's ext.* timers."""
import tracing


def read(ctx):
    return tracing.share(ctx, ("ext.",))
