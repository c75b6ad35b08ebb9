"""The edit loop: a native ``WorldSession`` at the CLI's position, the
camera turned down to the terrain in view. Each pair of edits deletes the
looked-at voxel, then places a hotbar block (every slot equally often,
in the seed's order) against the face the pick then finds, so the world changes but stays
bounded over hundreds of edits. The camera visits the traffic's table of
poses, in the order the seed gives, one pose a pair. Each edit is followed
by its fused frame (``render(mode="fused")``: the sync of the dirty
bricks, the pick, the draw); an edit's time runs from the edit call until
the card has finished that frame (span ``edit``). ``WorldSession.sync_ms``
after each frame is kept (the program's own host times of the sync).

The frames after ``sampled`` edits drawn from the seed below ``min_edits``
and after the window's last edit are kept for the check, with the edit log
(operation, slot and pose of every edit, the warm-up's included) and the
scene tables at the end.

Traffic keys: ``width``, ``height``, ``pos``, ``yaw``, ``pitch``, ``walk``,
``slots``, ``warmup_pairs``, ``min_edits``, ``sampled``, ``trace_seconds``.
"""

from __future__ import annotations

import numpy as np

from drivers import _session


class EditsState:
    pass


def _edit(st, j: int):
    """Edit ``j`` of the loop: (operation, slot, pose, changed voxel)."""
    s = st.session
    pose = st.poses[st.order[(j // 2) % len(st.order)]]
    _session.set_pose(s, pose)
    if j % 2 == 0:
        return "delete", None, pose, s.delete()
    slot = int(st.slots[(j // 2) % len(st.slots)])
    return "place", slot, pose, s.place(slot)


def setup(run):
    tr = run.traffic
    st = EditsState()
    st.session = _session.session(run)
    st.rcfg = _session.render_config(run)
    st.poses = _session.pose_table(tr)
    rng = np.random.default_rng(run.seed)
    st.order = rng.permutation(len(st.poses))
    # every seed places the same blocks, in an order of its own
    st.slots = rng.permutation(np.arange(len(st.poses)) % int(tr["slots"]))
    st.sample = set(rng.choice(int(tr["min_edits"]), int(tr["sampled"]), replace=False).tolist())
    # warm-up on the cell's shapes: edits and their frames (logged: the
    # check replays them too)
    s = st.session
    st.log = []
    for j in range(2 * int(tr["warmup_pairs"])):
        op, slot, pose, _ = _edit(st, j)
        st.log.append((op, slot, pose))
        s.render(st.rcfg, mode="fused")
    st.warm = len(st.log)
    run.sync()
    return st


def window(run, st, seconds: float) -> None:
    s = st.session
    st.kept, st.sync_ms = [], []
    failed = 0
    run.open_window()
    j = 0
    while True:
        with run.span("edit", sync=True):
            with run.span("edit_op"):
                op, slot, pose, where = _edit(st, st.warm + j)
            img = s.render(st.rcfg, mode="fused")
        st.sync_ms.append(sum(s.sync_ms.values()))
        failed += where is None
        st.log.append((op, slot, pose))
        if j in st.sample:
            st.kept.append((st.warm + j, img))
        last = (st.warm + j, img)
        j += 1
        if run.elapsed() >= seconds:
            break
    run.close_window()
    if last[0] - st.warm not in st.sample:
        st.kept.append(last)
    run.records.update(edits=j, attempted=j, failed=failed, sync_ms=st.sync_ms)


def drive(run):
    """Set up, then the timed window; returns the state ``outputs`` reads."""
    st = setup(run)
    window(run, st, run.window_seconds())
    return st


def outputs(run, st) -> dict:
    sc = st.session.scene
    cpu = lambda t: t.cpu().numpy()  # noqa: E731
    tables = {"grid_enc": cpu(sc.grid_enc), "brick_mat": cpu(sc.brick_mat),
              "brick_dist": cpu(sc.brick_dist), "brick_dist_shadow": cpu(sc.brick_dist_shadow),
              "albedo": cpu(sc.albedo), "flags": cpu(sc.flags), "metadata": cpu(sc.metadata),
              "y_max": int(sc.y_max)}
    return {"log": st.log, "frames": [(j, img.cpu()) for j, img in st.kept],
            "tables": tables, "rcfg": st.rcfg}
