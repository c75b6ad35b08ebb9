"""Device time of the NCCL all-reduce kernels that run inside the program's
``grad_sync`` range, per grad sync (one a step): the gradients' all-reduce
alone; none for a program without the range."""

from roofline import allreduce


def read(run):
    spans = run.records.get("grad_sync_s")
    if not spans or not run.device_trace:
        return None
    return 1e3 * allreduce.kernel_s_in(run, spans) / len(spans)
