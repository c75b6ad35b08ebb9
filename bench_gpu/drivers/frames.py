"""The viewer: a closed loop of full-feature frames of a native
``WorldSession`` (``render(mode="fused")``: sync, the looked-at pick, the
fused march and its shading). The camera visits the traffic's table of
poses in the order the seed gives, and the clock advances ``frame_dt`` a
frame, so the water moves. A frame ends when the card has finished it
(span ``frame``, synchronised); nothing is copied to the host.

The frames at ``sampled`` indices drawn from the seed below ``min_frames``,
and the window's last frame, are kept for the check.

Traffic keys: ``width``, ``height``, ``pos``, ``look``, ``walk``
(``poses``, ``walk_seed``, ``yaw_deg``, ``pitch_deg``, ``move``),
``frame_dt``, ``warmup_frames``, ``min_frames``, ``sampled``,
``trace_seconds``, ``roofline_frames``.
"""

from __future__ import annotations

import numpy as np

from drivers import _session


class FramesState:
    pass


def setup(run):
    tr = run.traffic
    st = FramesState()
    st.session = _session.session(run)
    st.rcfg = _session.render_config(run)
    st.poses = _session.pose_table(tr)
    rng = np.random.default_rng(run.seed)
    st.order = rng.permutation(len(st.poses))
    st.sample = set(rng.choice(int(tr["min_frames"]), int(tr["sampled"]), replace=False).tolist())
    # warm-up: the cell's frame shape at poses of the table, clock at 0
    for i in range(int(tr["warmup_frames"])):
        _session.set_pose(st.session, st.poses[i % len(st.poses)])
        st.session.time = 0.0
        st.session.render(st.rcfg, mode="fused")
    run.sync()
    return st


def window(run, st, seconds: float) -> None:
    from raytracing_test_tpu_torch.kernels import fused_march

    s, dt = st.session, float(run.traffic["frame_dt"])
    st.kept, st.shown = [], []
    launches = fused_march.LAUNCHES
    run.open_window()
    k = 0
    while True:
        pose = st.poses[st.order[k % len(st.order)]]
        _session.set_pose(s, pose)
        s.time = k * dt
        with run.span("frame", sync=True):
            img = s.render(st.rcfg, mode="fused")
        if k in st.sample:
            st.kept.append((k, pose, s.time, img))
        last = (k, pose, s.time, img)
        if k < int(run.traffic.get("roofline_frames", 0)):
            st.shown.append((pose, s.time))
        k += 1
        if run.elapsed() >= seconds:
            break
    run.close_window()
    if last[0] not in st.sample:
        st.kept.append(last)
    run.records.update(frames=k, attempted=k, failed=0,
                       march_launches=fused_march.LAUNCHES - launches)


def drive(run):
    """Set up, then the timed window; returns the state ``outputs`` reads."""
    st = setup(run)
    window(run, st, run.window_seconds())
    return st


def outputs(run, st) -> dict:
    return {"frames": [(k, pose, t, img.cpu()) for k, pose, t, img in st.kept],
            "shown": st.shown, "rcfg": st.rcfg}
