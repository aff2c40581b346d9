"""Share of the window under the program's seed.* timers."""
import tracing


def read(ctx):
    return tracing.share(ctx, ("seed.",))
