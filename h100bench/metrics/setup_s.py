"""Seconds from the run's start to its first timed epoch: inputs, batching,
staging, the kernel library's load (its build in a checkout's first run) and
the warm-up epochs."""


def read(ctx):
    return ctx["spans"]["setup_s"]
