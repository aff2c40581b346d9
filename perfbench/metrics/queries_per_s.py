"""Queries of all the (untraced) window's requests over that window (first
request's start to the last one's end)."""


def read(ctx):
    return ctx["queries"] / ctx["queries_window_s"]
