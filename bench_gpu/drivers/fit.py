"""The fit: ``app/fit.py:fit_world``, the guided inverse-rendering loop a
user runs, called whole on the configuration's world.

Set-up builds the world and its scene as the CLI's ``fit`` does, then
calls ``fit_world``. The harness sees inside it only through the module
attributes ``fit_world`` looks up at call time, each wrapped while it runs
(as ``faults.py`` patches them):

    sharding.make_train_step_fused   the step it returns runs in the span
                                     ``step``; the first ``checked_steps``
                                     keep their losses, Adam's first moment
                                     after step 0 and the fields' change over
                                     them, then the window opens
    sharding.guide_scene_from_params span ``guide_rebuild``; keeps a copy of
                                     the density field it thresholds
    progressive.guided_seeds         keeps the last step's seeds
    numpy.random.default_rng         keeps the last step's batch indices

So set-up runs ``fit_world``'s targets, fields, Adam, first guide and
checked steps, and the window is the rest of that same fit. It closes
after the first whole number of re-threshold periods (each holds one guide
rebuild and ``rethreshold_every`` steps) that fills its seconds, when the
wrapped step raises ``WindowClosed`` out of ``fit_world``; a window cut
inside a period would count a share of its rebuild that depends on where
the clock stopped. The check compares the checked steps, and the seeds the
window's last step marched on the window's last guide, with the reference.

Traffic keys: ``views``, ``resolution`` (target views of that side),
``batch`` (rays a step), ``checked_steps``, ``trace_seconds``,
``roofline_steps`` (traced steps whose window launches are counted).
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch


class WindowClosed(Exception):
    """Raised by the wrapped step to end ``fit_world`` when the window has
    closed."""


class FitState:
    pass


def _configs(run):
    from raytracing_test_tpu_torch.config import FitConfig, WorldConfig

    c, tr = run.config, run.traffic
    world = {k: tuple(v) if isinstance(v, list) else v for k, v in c["world"].items()}
    fit = c["fit"]
    if fit["engine"] != "fused":
        raise ValueError(f"the reference follows the guided fused fit, "
                         f"not engine {fit['engine']!r}")
    # more steps than any window holds: the window's close ends the fit
    fcfg = FitConfig(views=tr["views"], resolution=tr["resolution"], lr=fit["lr"],
                     rethreshold_every=fit["rethreshold_every"], guide_tau=fit["guide_tau"],
                     guided_steps=fit["guided_steps"], engine=fit["engine"],
                     shading=fit["shading"], steps=2 ** 62)
    return WorldConfig(**world), fcfg


@contextlib.contextmanager
def _wrapped(obj, name: str, make):
    """``obj.name`` replaced by ``make(obj.name)`` while the body runs."""
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


class _RecordedRng:
    """A numpy generator that keeps the last indices it drew."""

    def __init__(self, rng):
        self.rng = rng
        self.last = None

    def integers(self, *a, **kw):
        self.last = self.rng.integers(*a, **kw)
        return self.last


def _first_grad_norm(optimizer, p) -> float:
    """The norm of the gradient Adam took in its first step, from its first
    moment (which is then (1 - beta1) g); 0 where it holds none."""
    state = optimizer.state.get(p, {})
    if "exp_avg" not in state:
        return 0.0
    return float((state["exp_avg"] / (1 - optimizer.defaults["betas"][0])).double().norm())


def drive(run):
    from raytracing_test_tpu_torch.app import fit as fitmod
    from raytracing_test_tpu_torch.core.flatten import scene_from_grid
    from raytracing_test_tpu_torch.kernels import fused_window
    from raytracing_test_tpu_torch.parallel import sharding
    from raytracing_test_tpu_torch.render import progressive
    from raytracing_test_tpu_torch.worldgen import terrain

    wcfg, fcfg = _configs(run)
    st = FitState()
    st.fcfg, st.batch = fcfg, int(run.traffic["batch"])
    checked = int(run.traffic["checked_steps"])
    n_count = int(run.traffic.get("roofline_steps", 0)) if run.trace else 0
    period = fcfg.rethreshold_every
    seconds = run.window_seconds()
    grid, pal = terrain.gen_world_grid(wcfg)
    st.grid_shape = grid.shape
    scene = scene_from_grid(grid, pal, run.device)
    del grid
    st.step, st.losses, st.traced = 0, [], []
    st.density = st.seeds = st.rng = None

    def make_rebuild(rebuild):
        def recorded(params, *a, **kw):
            with run.span("guide_rebuild", sync=run.trace):
                if st.density is None:
                    st.density = torch.empty_like(params.density_raw)
                st.density.copy_(params.density_raw.detach())
                st.guide = rebuild(params, *a, **kw)
            return st.guide
        return recorded

    def make_seeds(guided_seeds):
        def recorded(*a, **kw):
            st.seeds = guided_seeds(*a, **kw)
            return st.seeds
        return recorded

    def make_rng(default_rng):
        def recorded(*a, **kw):
            st.rng = _RecordedRng(default_rng(*a, **kw))
            return st.rng
        return recorded

    def make_step(make):
        def made(params, optimizer, *a, **kw):
            step = make(params, optimizer, *a, **kw)
            leaves = (params.density_raw, params.albedo_raw)

            def recorded(origins, dirs, targets, guide=None):
                s = st.step
                if s == 0:
                    st.init = [p.detach().clone() for p in leaves]
                with run.span("step", sync=run.trace):
                    loss, aux = step(origins, dirs, targets, guide=guide)
                st.step += 1
                if s < checked:
                    st.losses.append(float(loss))
                    if s == 0:
                        st.grad_norms = [_first_grad_norm(optimizer, p) for p in leaves]
                    if s == checked - 1:
                        st.change_norms = [float((p.detach() - p0).double().norm())
                                           for p, p0 in zip(leaves, st.init)]
                        del st.init
                        st.launches = (fused_window.LAUNCHES_FWD, fused_window.LAUNCHES_BWD)
                        run.open_window()
                    return loss, aux
                if s - checked < n_count:
                    st.traced.append((origins, dirs, st.guide))
                if (s + 1 - checked) % period == 0 and run.elapsed() >= seconds:
                    run.close_window()
                    raise WindowClosed
                return loss, aux
            return recorded
        return made

    with contextlib.ExitStack() as patches, contextlib.redirect_stdout(sys.stderr):
        patches.enter_context(_wrapped(sharding, "make_train_step_fused", make_step))
        patches.enter_context(_wrapped(sharding, "guide_scene_from_params", make_rebuild))
        patches.enter_context(_wrapped(progressive, "guided_seeds", make_seeds))
        patches.enter_context(_wrapped(np.random, "default_rng", make_rng))
        try:
            fitmod.fit_world(scene, st.grid_shape, fcfg, batch=st.batch, seed=run.seed)
        except WindowClosed:
            pass
    n = st.step - checked
    run.records.update(steps=n, rays=n * st.batch, attempted=n, failed=0,
                       window_launches=(fused_window.LAUNCHES_FWD - st.launches[0],
                                        fused_window.LAUNCHES_BWD - st.launches[1]))
    return st


def outputs(run, st) -> dict:
    """What the check needs: the checked steps' readings, and the window's
    last batch (its indices and the seeds the program marched) with the
    density field its guide was thresholded from. In a traced run also the
    bound of each counted step's window launch pair (``roofline/window.py``),
    from its rays and the guide it ran on."""
    if st.traced:
        from roofline import window as wroof

        run.records["window_bound_s"] = [
            wroof.step_bound(guide, o, d, st.grid_shape, st.fcfg.guided_steps)
            for o, d, guide in st.traced]
    return {"losses": st.losses, "grad_norms": st.grad_norms, "change_norms": st.change_norms,
            "N": st.fcfg.views * st.fcfg.resolution ** 2, "grid_shape": st.grid_shape,
            "batch": st.batch, "views": st.fcfg.views, "resolution": st.fcfg.resolution,
            "seed_idx": np.asarray(st.rng.last), "seeds": st.seeds.cpu(),
            "seed_density": st.density.cpu()}
