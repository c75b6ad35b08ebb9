"""PyTorch port: the data-parallel fit's guided step on 2 and 4 gloo ranks
against the plain reference of the benchmark (``bench_gpu/reference/train.py``),
the single-device guided fit, on the whole batch of each step.

With blocks of equal size the mean of the ranks' block losses is the loss
of the whole batch and the mean of their gradients is its gradient, so
``FIT_DP_STEPS`` data-parallel steps (``tests/torch_parallel_ranks.py:
fit_dp_steps``, started by ``launch.run_ranks``) must give the reference's
losses, Adam's first moment after step 0 and the fields' change, on the
seeded random fields of ``raw_params`` and one guide thresholded from them.
Every rank must hold the same fields, bit for bit. The program's counters
advance by what the steps hand to the all-reduce, and the ``grad_sync``
range shows in a CPU profiler trace. The same steps with the gradient's
all-reduce in bfloat16 fail a tolerance.
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracing_test_tpu_torch.parallel.launch import run_ranks
from tests import torch_parallel_ranks as R

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "bench_gpu"))
from reference import train as rt  # noqa: E402

torch.set_num_threads(1)

RANKS = [2, 4]
TIMEOUT = 120.0
# Each tolerance lies between what the steps read on 2 and 4 ranks and what
# they read with the gradient's all-reduce in bfloat16.
# The reference takes the loss over the whole batch in one float32 mean,
# the ranks over their blocks, then average the block means: the two round
# differently by a few float32 ulps (7e-8); bfloat16 moves the third step's
# loss by 1.4e-5
LOSS_RTOL = 1e-6
# the first moment is (1 - beta1) g: the reference sums each cell's
# gradient in float64, the ranks in float32 over their blocks and then add
# the blocks' sums in float32 (1.2e-7 of the largest); bfloat16 is off by
# about 2^-9 of it (4.5e-3)
MOMENT_TOL = 1e-5
# Adam moves a cell by about lr a step wherever its gradient is well above
# eps; where a cell's summed gradient nearly cancels, rounding can turn its
# sign, so the change is held by its norm: the difference's norm over the
# reference change's norm (6e-7; bfloat16 7.5e-3)
CHANGE_TOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(ranks, bf16): (output dir, every rank's returned dict)}: one world of
    ranks for each, the worlds at once."""
    cases = [(n, False) for n in RANKS] + [(2, True)]
    dirs = {c: tmp_path_factory.mktemp(f"fit_dp{c[0]}{'_bf16' if c[1] else ''}") for c in cases}
    with ThreadPoolExecutor(len(cases)) as pool:
        futures = {c: pool.submit(run_ranks, R.fit_dp_steps, c[0], timeout=TIMEOUT,
                                  args=(c[0], str(dirs[c]), c[1])) for c in cases}
        return {c: (dirs[c], f.result()) for c, f in futures.items()}


@pytest.fixture(scope="module")
def reference():
    """The reference's losses, first moment after step 0 and fields after
    the steps, from the same fields, guide and batches."""
    ref = rt.Fit(R.FIELD_SHAPE, R.LR, device="cpu")
    d, a = R.raw_params()
    ref.density_raw.copy_(torch.from_numpy(d))
    ref.albedo_raw.copy_(torch.from_numpy(a))
    guide = rt.guide_scene(ref.density_raw, 1.0)
    losses = []
    for k in range(R.FIT_DP_STEPS):
        o, dr, t = (torch.from_numpy(x) for x in R.fit_dp_batch(k))
        loss, grads = ref.loss_and_grads(guide, o, dr, t, 24)
        ref.adam(grads)
        losses.append(loss)
        if k == 0:
            moments = [m.clone() for m in ref.m]
    return {"losses": np.asarray(losses), "moments": [m.numpy() for m in moments],
            "fields": [p.numpy() for p in ref.leaves()], "init": [d, a]}


def _load(d, name: str, rank: int = 0) -> np.ndarray:
    return np.load(d / f"{name}_r{rank}.npy")


def _max_scaled(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _gaps(d, reference) -> dict:
    """Rank 0's loss, first moment and change against the reference's."""
    loss = _load(d, "fit_dp_loss")
    moments = [_load(d, f"fit_dp_m_{k}") for k in ("density", "albedo")]
    fields = [_load(d, f"fit_dp_{k}") for k in ("density", "albedo")]
    change = []
    for f, ref, init in zip(fields, reference["fields"], reference["init"]):
        want = ref.astype(np.float64) - init
        change.append(np.linalg.norm(f.astype(np.float64) - init - want) / np.linalg.norm(want))
    return {"loss": float(np.max(np.abs(loss - reference["losses"]) / reference["losses"])),
            "moment": max(_max_scaled(m, r) for m, r in zip(moments, reference["moments"])),
            "change": max(change)}


@pytest.mark.parametrize("n", RANKS)
def test_dp_steps_match_the_reference(runs, reference, n):
    d, res = runs[(n, False)]
    assert len(res) == n and not any(r["jax_imported"] for r in res)
    gaps = _gaps(d, reference)
    assert gaps["loss"] <= LOSS_RTOL, gaps
    assert gaps["moment"] <= MOMENT_TOL, gaps
    assert gaps["change"] <= CHANGE_TOL, gaps


@pytest.mark.parametrize("n", RANKS)
def test_replicas_are_bit_equal(runs, n):
    d, _ = runs[(n, False)]
    for name in ("fit_dp_density", "fit_dp_albedo", "fit_dp_m_density", "fit_dp_m_albedo",
                 "fit_dp_loss"):
        first = _load(d, name)
        for r in range(1, n):
            np.testing.assert_array_equal(_load(d, name, r), first)


@pytest.mark.parametrize("n", RANKS)
def test_counters_advance_by_the_reduced_gradient(runs, n):
    """One grad sync a step; each hands the two fields' gradients, 16 B a
    cell (density and three albedo channels in float32), to the all-reduce,
    and the step's loss statistics add 12 B (three float32)."""
    _, res = runs[(n, False)]
    cells = int(np.prod(R.FIELD_SHAPE))
    for r in res:
        assert r["grad_syncs"] == R.FIT_DP_STEPS
        assert r["reduced_bytes"] == R.FIT_DP_STEPS * (16 * cells + 12)


@pytest.mark.parametrize("n", RANKS)
def test_grad_sync_range_in_a_profiled_step(runs, n):
    _, res = runs[(n, False)]
    assert all("grad_sync" in r["ranges"] for r in res)


def test_bf16_allreduce_fails_a_tolerance(runs, reference):
    d, _ = runs[(2, True)]
    gaps = _gaps(d, reference)
    assert (gaps["loss"] > LOSS_RTOL or gaps["moment"] > MOMENT_TOL
            or gaps["change"] > CHANGE_TOL), gaps
