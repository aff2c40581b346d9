"""Share of the window under no named span of a request: for every
``cli.request`` span (one ``cli.main`` call) in the window, its time less
the union of its direct children's (through the spans' parent ids), summed
and over the window.  Read from the program's own span records
(``utils.log.spans``); nothing where the program keeps none."""
from collections import defaultdict

import tracing


def read(ctx):
    if "window" not in ctx:
        return None
    from diamond_tpu_torch.utils import log

    spans = getattr(log, "spans", None)
    if spans is None:
        return None
    a0, a1 = ctx["window"]
    got = spans((a0, a1))
    kids = defaultdict(list)
    for s in got:
        if s.parent is not None:
            kids[s.parent].append(s)
    total, n = 0.0, 0
    for r in got:
        if r.label != "cli.request":
            continue
        a, b = max(r.t0, a0), min(r.t1, a1)
        inner = [(max(k.t0, a), min(k.t1, b)) for k in kids[r.id]]
        total += b - a - tracing.union_s([(x, y) for x, y in inner if y > x])
        n += 1
    return total / ctx["window_s"] if n else None
