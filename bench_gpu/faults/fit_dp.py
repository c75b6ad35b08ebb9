"""Faults planted under the data-parallel fit's timed path
(``drivers/fit_dp.py``) on every rank, for the tests that show a run then
reads ``correct`` false (``tests/test_bench_faults.py``) and for the
readings that set the limits (``calibrate.py``).

    unsynced_rank  the last rank keeps its own gradient: it hands a copy to
                   the all-reduce (the other ranks wait for its part) and
                   leaves its buffer as it was
    summed_grads   the gradients are summed over the ranks, not averaged
    same_block     every rank trains on rank 0's block of the batch
    stale_guide    every guide rebuild returns the fit's first guide (the
                   fit's fault, ``faults/fit.py``)
"""

from __future__ import annotations

import torch.distributed as dist

import harness
from faults._patch import patched

FAULTS = ("unsynced_rank", "summed_grads", "same_block", "stale_guide")


def plant(fault: str):
    from raytracing_test_tpu_torch.parallel import mesh as meshlib
    from raytracing_test_tpu_torch.parallel import sharding

    if fault == "unsynced_rank":
        psum_ = meshlib.Mesh.psum_

        def unsynced(self, x, axis):
            if dist.get_rank() != dist.get_world_size() - 1:
                return psum_(self, x, axis)
            psum_(self, x.clone(), axis)
            return x
        return patched(meshlib.Mesh, "psum_", unsynced)
    if fault == "summed_grads":
        average = sharding.average_grads

        def summed(params, mesh):
            average(params, mesh)
            for p in (params.density_raw, params.albedo_raw):
                p.grad.mul_(mesh.axis_size(meshlib.DATA_AXIS))
        return patched(sharding, "average_grads", summed)
    if fault == "same_block":
        def first_block(self, x, axis=meshlib.DATA_AXIS):
            return x[:x.shape[0] // self.shape[axis]]
        return patched(meshlib.Mesh, "block", first_block)
    if fault == "stale_guide":
        return harness.load_module("faults", "fit").plant(fault)
    raise ValueError(f"the data-parallel fit has no fault {fault!r}")
