"""World and fit checkpoints as npz, in the JAX package's layouts.

Port of ``raytracing_test_tpu/app/checkpoint.py``. A world (the dense grid and
its palette, i.e. seeds and edits) is saved by ``save_world`` (:20) and read
by ``load_world`` (:31) in the reference's npz keys (``grid``, ``pal_flags``,
``pal_color``, ``pal_meta``, ``meta_*``), so a world saved by either package
loads in the other.

``save_fit`` / ``load_fit`` (:44): the reference flattens ``(params, opt_state, step)`` into ``leaf_0..leaf_7``:
density_raw, albedo_raw, the Adam count, mu (density, albedo), nu (density,
albedo) and the step. This module writes and reads that same layout, so a
checkpoint of either package loads in the other; the state crosses over
through ``parallel/sharding.py``'s converters.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.tree import Palette

from ..parallel.sharding import (
    FitParams,
    adam_state_from_optax,
    adam_state_to_optax,
    params_from_jax,
)


def save_world(path: str, grid: np.ndarray, palette: Palette, meta: Optional[dict] = None) -> None:
    np.savez_compressed(
        path,
        grid=grid,
        pal_flags=palette.flags,
        pal_color=palette.color,
        pal_meta=palette.metadata,
        **({f"meta_{k}": v for k, v in (meta or {}).items()}),
    )


def load_world(path: str) -> Tuple[np.ndarray, Palette]:
    data = np.load(path)
    pal = Palette(flags=data["pal_flags"], color=data["pal_color"], metadata=data["pal_meta"])
    # rebuild the interning index
    for i in range(1, len(pal.flags)):
        pal._index[(int(pal.flags[i]), int(pal.color[i]), float(pal.metadata[i]))] = i
    return data["grid"], pal


def save_fit(path: str, params: FitParams, optimizer: torch.optim.Adam, step: int) -> None:
    """Save FitParams, the Adam state and the step to ``path`` (npz)."""
    count, mu, nu = adam_state_to_optax(optimizer, params)
    leaves = [
        params.density_raw.detach().cpu().numpy(), params.albedo_raw.detach().cpu().numpy(),
        count, mu[0], mu[1], nu[0], nu[1], np.asarray(step),
    ]
    np.savez_compressed(path, **{f"leaf_{i}": l for i, l in enumerate(leaves)})


def load_fit(path: str, device="cuda"):
    """Load a checkpoint written by either package's ``save_fit`` ->
    (FitParams, Adam state for ``sharding.load_adam_state``, step)."""
    data = np.load(path)
    if len(data.files) != 8:
        raise ValueError(f"{path}: expected the 8 leaves of (FitParams, adam state, step), "
                         f"found {sorted(data.files)}")
    leaf = [data[f"leaf_{i}"] for i in range(8)]
    params = params_from_jax(leaf[0], leaf[1], device)
    states = adam_state_from_optax(leaf[2], (leaf[3], leaf[4]), (leaf[5], leaf[6]))
    return params, states, int(leaf[7])
