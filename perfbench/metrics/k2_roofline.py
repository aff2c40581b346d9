"""K2's share of its roofline: the least time of the window's launches'
work (roofline.py) over their CUDA-event time, in percent."""
import tracing


def read(ctx):
    return tracing.roofline_share(ctx, "k2")
