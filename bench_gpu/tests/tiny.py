"""A cell's spec shrunk to a size the CPU tests can hold: the same files,
with the world cut to 16x16 columns in a 64x128x64 window, the traffic to
a few small views and frames, and the fit's guide rebuilt every 3 steps."""

import copy

import harness

TINY_TRAFFIC = {
    "fit": {"views": 2, "resolution": 8, "batch": 64},
    "frames": {"width": 16, "height": 16, "min_frames": 2, "sampled": 2,
               "pos": [8.0, 45.0, -6.0], "look": [0.1, -0.6, 1.0]},
    "edits": {"width": 16, "height": 16, "min_edits": 4, "sampled": 2,
              "pos": [8.0, 45.0, 8.0]},
}


def tiny_spec(workload: str) -> dict:
    spec = copy.deepcopy(harness.load_spec(workload))
    w = spec["config"]["world"]
    w.update(width=16, length=16, grid_shape=[64, 128, 64])
    spec["traffic"].update(TINY_TRAFFIC[spec["traffic"]["driver"]])
    # a rebuild every 3 steps, and a rate at which the fields move enough in
    # that many for the guide to prune cells
    spec["config"]["fit"].update(rethreshold_every=3, lr=0.5)
    return spec


def tiny_seconds(spec: dict) -> float:
    """The tiny run's window: the fit's is long enough for its guide to prune
    cells in the batch's way, so that a stale guide shows."""
    return 4.0 if spec["traffic"]["driver"] == "fit" else 0.3
