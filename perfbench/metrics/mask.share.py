"""Share of the window under the program's mask.* spans (the masking of a
block, ``search/pipeline.mask_block``: the DB's and the queries' every
request), nested spans counted once.  Read from the program's own span
records (``utils.log.spans``); nothing where the program keeps none."""
import tracing


def read(ctx):
    if "window" not in ctx:
        return None
    from diamond_tpu_torch.utils import log

    spans = getattr(log, "spans", None)
    if spans is None:
        return None
    got = [(s.label, s.t0, s.t1) for s in spans(ctx["window"], "mask.")]
    if not got:
        return None
    return tracing.spans_s(got, ("mask.",), ctx["window"]) / ctx["window_s"]
