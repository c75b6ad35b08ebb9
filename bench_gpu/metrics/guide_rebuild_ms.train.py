"""Mean host time of one guide rebuild (``guide_scene_from_params``,
synchronised) in the window; none when the window held no rebuild."""


def read(run):
    t = run.spans.get("guide_rebuild", [])
    return 1e3 * sum(t) / len(t) if t else None
