"""Mean device span of the program's ``grad_sync`` range
(``parallel/sharding.py:average_grads``: the coalescing copy, the
all-reduce, the division and the copy back) over the traced window's grad
syncs, one a step; none for a program without the range."""


def read(run):
    spans = run.records.get("grad_sync_s")
    return 1e-3 * sum(e - s for s, e in spans) / len(spans) if spans else None
