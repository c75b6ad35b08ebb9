"""A cell's spec shrunk to a size the CPU tests can hold: the same files,
with the world cut to 16x16 columns in a 64x128x64 window, and the
traffic, configuration and window cut by the driver's own file of sizes,
``tests/tiny/<driver>.json``: ``traffic`` and ``config`` (each section
updated key by key) and the window's ``seconds``."""

import copy
from pathlib import Path

import harness

TINY_DIR = Path(__file__).resolve().parent / "tiny"


def sizes(driver: str) -> dict:
    """The driver's tiny sizes; raises naming the file where it has none."""
    path = TINY_DIR / f"{driver}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no tiny sizes for driver {driver!r}: {path} is missing")
    return harness.load_json(path)


def tiny_spec(workload: str) -> dict:
    spec = copy.deepcopy(harness.load_spec(workload))
    cut = sizes(spec["traffic"]["driver"])
    spec["config"]["world"].update(width=16, length=16, grid_shape=[64, 128, 64])
    spec["traffic"].update(cut["traffic"])
    for section, keys in cut["config"].items():
        spec["config"][section].update(keys)
    return spec


def tiny_seconds(spec: dict) -> float:
    """The tiny run's window (the driver's ``seconds``)."""
    return float(sizes(spec["traffic"]["driver"])["seconds"])
