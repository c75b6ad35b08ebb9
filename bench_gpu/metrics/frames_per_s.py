"""Viewer throughput: frames completed in the window over its length."""


def read(run):
    return run.records["frames"] / run.records["window_s"]
