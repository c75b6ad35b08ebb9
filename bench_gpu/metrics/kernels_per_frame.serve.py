"""Device operations (kernels, copies, fills) the traced window ran, per
frame."""


def read(run):
    t = run.device_trace
    if not t or not run.records.get("frames"):
        return None
    return sum(t["op_count"].values()) / run.records["frames"]
