"""Kernel launches in the traced serving window over its batches."""


def read(run):
    return run.trace["kernels"] / run.trace["batches"]
