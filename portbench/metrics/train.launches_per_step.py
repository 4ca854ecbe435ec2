"""Kernel launches in the traced training window over its steps."""


def read(run):
    return run.trace["kernels"] / run.trace["steps"]
