"""Share of the window under the program's swipe.* timers."""
import tracing


def read(ctx):
    return tracing.share(ctx, ("swipe.",))
