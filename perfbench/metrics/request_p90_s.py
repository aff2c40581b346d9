"""90th percentile of the latency of every request of the untraced window
(closed loop: from the request's start; a traced run runs that window
before its traced one).  Also the reader of the per-layer
``request_p90_s.<cell>``."""
import tracing


def read(ctx):
    return tracing.percentile(ctx["latencies"], 90)
