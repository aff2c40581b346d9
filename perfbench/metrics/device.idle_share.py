"""Share of the window in which no operation ran on the card: 1 - the
profiler trace's busy time (CUDA-event time of the wrapped kernel calls
where the trace holds no device operation) over the window."""


def read(ctx):
    if "busy_s" not in ctx or ctx["busy_s"] <= 0:
        return None
    return 1.0 - ctx["busy_s"] / ctx["window_s"]
