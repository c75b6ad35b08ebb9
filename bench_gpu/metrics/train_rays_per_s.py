"""Fit throughput: the rays of every step completed in the window over the
window's whole length, guide rebuilds included."""


def read(run):
    return run.records["rays"] / run.records["window_s"]
