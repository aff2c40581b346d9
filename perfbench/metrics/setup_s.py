"""Seconds from the run's start to the end of its warm request."""


def read(ctx):
    return ctx["setup_s"]
