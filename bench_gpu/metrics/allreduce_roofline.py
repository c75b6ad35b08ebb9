"""Share of the gradients' all-reduce's roofline in the data-parallel fit,
over every step of the traced window: the bound of one grad sync, the ring
traffic of the bytes it hands to the all-reduce (``Mesh.reduced_bytes``'
advance inside ``average_grads`` over ``sharding.GRAD_SYNCS``' advance) at
NVLink's rate (``roofline/allreduce.py``), over the device time of the NCCL
all-reduce kernels inside the program's ``grad_sync`` range per range; none
for a program without the counters or the range."""

from roofline import allreduce


def read(run):
    r = run.records
    spans, syncs, nbytes = r.get("grad_sync_s"), r.get("grad_syncs"), r.get("grad_sync_bytes")
    if not spans or not syncs or not nbytes or not run.device_trace:
        return None
    t = allreduce.kernel_s_in(run, spans)
    if t <= 0:
        return None
    return 100.0 * allreduce.bound_s(nbytes / syncs, r["ranks"]) * len(spans) / t
