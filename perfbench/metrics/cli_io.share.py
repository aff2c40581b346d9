"""Share of the window under the program's cli.load and cli.write timers."""
import tracing


def read(ctx):
    return tracing.share(ctx, ("cli.load", "cli.write"))
