"""The data-parallel fit: ``app/fit.py:fit_world(mesh=)``, called whole on
every rank of the cell, one card a rank, the ranks joined in the harness's
group (``ranks.py``) and the mesh taken from it by ``make_mesh``.

Every rank builds the configuration's world and scene on its card and runs
the same fit: it draws the whole batch from the seed, takes its contiguous
block, and averages the fields' gradients over the mesh's data axis before
Adam (``parallel/sharding.py:average_grads``), so every rank keeps the same
fields. The harness sees inside the fit as the one-card fit driver does
(``drivers/fit.py``, whose helpers this driver uses): the step runs in the
span ``step``, the guide rebuild in ``guide_rebuild``, and the last step's
seeds and batch indices are kept. The window opens on every rank after the
checked steps and closes after the first whole number of re-threshold
periods that fills its seconds on rank 0's clock (``Run.agree``).

Over the window the driver reads the program's counters where it has them,
None for a program without them: ``sharding.GRAD_SYNCS``' advance
(``grad_syncs``) and, through ``sharding.average_grads`` wrapped while it
runs, the advance of the mesh's ``reduced_bytes`` inside the grad syncs
(``grad_sync_bytes``). In a traced run it keeps the device spans of the
program's ``grad_sync`` range (``grad_sync_s``: (start, end) in the trace's
microseconds), empty for a program without the range.

``outputs`` brings each rank's seeds of its block and a digest of its
fields to rank 0: the seeds of the whole last batch, in rank order, and
the digests the check holds to one replica.

Traffic keys: ``views``, ``resolution``, ``batch`` (rays a step over all
ranks: fit_world's ``batch``), ``checked_steps``, ``trace_seconds``. The
configuration's ``mesh`` gives the data and space axes.
"""

from __future__ import annotations

import contextlib
import hashlib
import sys

import numpy as np
import torch

import harness

fit = harness.load_module("drivers", "fit")


def _grad_sync_spans(profiler):
    """(start, end) of each device span of the range ``grad_sync`` among the
    stopped profiler's events."""
    from torch.autograd import DeviceType

    if profiler is None:
        return []
    return sorted((e.time_range.start, e.time_range.end) for e in profiler.events()
                  if e.name == "grad_sync" and e.device_type == DeviceType.CUDA)


def drive(run):
    from raytracing_test_tpu_torch.app import fit as fitmod
    from raytracing_test_tpu_torch.core.flatten import scene_from_grid
    from raytracing_test_tpu_torch.parallel import mesh as meshlib
    from raytracing_test_tpu_torch.parallel import sharding
    from raytracing_test_tpu_torch.render import progressive
    from raytracing_test_tpu_torch.worldgen import terrain

    shape = run.config["mesh"]
    if shape["data"] * shape["space"] != run.world:
        raise ValueError(f"a mesh of {shape} needs {shape['data'] * shape['space']} ranks, "
                         f"the cell has {run.world}")
    wcfg, fcfg = fit._configs(run)
    st = fit.FitState()
    st.fcfg, st.batch = fcfg, int(run.traffic["batch"])
    checked = int(run.traffic["checked_steps"])
    period = fcfg.rethreshold_every
    seconds = run.window_seconds()
    mesh = meshlib.make_mesh(shape["data"], shape["space"], device=run.device)
    grid, pal = terrain.gen_world_grid(wcfg)
    st.grid_shape = grid.shape
    scene = scene_from_grid(grid, pal, run.device)
    del grid
    st.step, st.losses, st.traced = 0, [], []  # no window launches are counted
    st.density = st.seeds = st.rng = st.sync_bytes = None

    def grad_syncs():
        return getattr(sharding, "GRAD_SYNCS", None)

    def make_sync(average_grads):
        def recorded(params, mesh_):
            if st.sync_bytes is None:
                return average_grads(params, mesh_)
            before = mesh_.reduced_bytes
            average_grads(params, mesh_)
            st.sync_bytes += mesh_.reduced_bytes - before
        return recorded

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
            st.rng = fit._RecordedRng(default_rng(*a, **kw))
            return st.rng
        return recorded

    def make_step(make):
        def made(params, optimizer, *a, **kw):
            step = make(params, optimizer, *a, **kw)
            st.leaves = (params.density_raw, params.albedo_raw)

            def recorded(origins, dirs, targets, guide=None):
                s = st.step
                if s == 0:
                    st.init = [p.detach().clone() for p in st.leaves]
                with run.span("step", sync=run.trace):
                    loss, aux = step(origins, dirs, targets, guide=guide)
                st.step += 1
                if s < checked:
                    st.losses.append(float(loss))
                    if s == 0:
                        st.grad_norms = [fit._first_grad_norm(optimizer, p) for p in st.leaves]
                    if s == checked - 1:
                        st.change_norms = [float((p.detach() - p0).double().norm())
                                           for p, p0 in zip(st.leaves, st.init)]
                        del st.init
                        run.open_window()
                        st.syncs0 = grad_syncs()
                        st.sync_bytes = 0 if hasattr(mesh, "reduced_bytes") else None
                    return loss, aux
                if (s + 1 - checked) % period == 0 and run.agree(run.elapsed() >= seconds):
                    syncs = grad_syncs()
                    profiler = run._profiler
                    run.close_window()
                    st.grad_syncs = None if syncs is None else syncs - st.syncs0
                    st.grad_sync_s = _grad_sync_spans(profiler)
                    raise fit.WindowClosed
                return loss, aux
            return recorded
        return made

    threads = torch.get_num_threads()
    if run.world > 1:
        torch.set_num_threads(1)  # one intra-op thread a rank, as torchrun sets it
    try:
        with contextlib.ExitStack() as patches, contextlib.redirect_stdout(sys.stderr):
            patches.enter_context(fit._wrapped(sharding, "make_train_step_fused", make_step))
            patches.enter_context(fit._wrapped(sharding, "guide_scene_from_params",
                                               make_rebuild))
            patches.enter_context(fit._wrapped(progressive, "guided_seeds", make_seeds))
            patches.enter_context(fit._wrapped(np.random, "default_rng", make_rng))
            patches.enter_context(fit._wrapped(sharding, "average_grads", make_sync))
            try:
                fitmod.fit_world(scene, st.grid_shape, fcfg, batch=st.batch, seed=run.seed,
                                 mesh=mesh)
            except fit.WindowClosed:
                pass
    finally:
        torch.set_num_threads(threads)
    n = st.step - checked
    run.records.update(steps=n, rays=n * st.batch, attempted=n, failed=0, ranks=run.world,
                       grad_syncs=st.grad_syncs, grad_sync_bytes=st.sync_bytes,
                       grad_sync_s=st.grad_sync_s)
    return st


def _digest(leaves) -> str:
    """SHA-256 of the fields' bytes, in order."""
    h = hashlib.sha256()
    for p in leaves:
        h.update(np.ascontiguousarray(p.detach().cpu().numpy()))
    return h.hexdigest()


def outputs(run, st):
    """On rank 0, what the fit's check needs (``drivers/fit.py:outputs``)
    with the seeds of the whole last batch gathered from the ranks' blocks,
    and every rank's digest of its fields after the window; None on the
    other ranks."""
    parts = run.gather({"seeds": st.seeds.cpu(), "digest": _digest(st.leaves)})
    if parts is None:
        return None
    out = fit.outputs(run, st)
    out["seeds"] = torch.cat([p["seeds"] for p in parts])
    out["digests"] = [p["digest"] for p in parts]
    return out
