"""The window's train step time: the steps' summed host time (each call
ended by ``float(loss)``) over their number."""


def read(run):
    t = run.spans.get("step", [])
    return 1e3 * sum(t) / len(t) if t else None
