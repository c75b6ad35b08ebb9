"""Spatial sharding by ray handoff: each x-slab marches only the rays inside
it, and rays that leave are shipped to the neighbouring slab.

Port of ``raytracing_test_tpu/parallel/handoff.py``. parallel/spatial.py
answers every lookup with a sum over the space axis, one all-reduce per DDA
step; here a rank marches the lanes whose current cell lies in its slab with
``render/fast.py``'s march body against its slab of ``grid_enc`` (so the
march keeps the fast path's jump boxes, analytic exits and materials; the
exit rules see the whole world's ``shape3``), and lanes that cross into
another slab are frozen and shipped one hop toward their owner.

Protocol: every space rank holds the state of all N lanes of its data block;
``resident`` marks the one rank that owns each lane.

  round := march the resident lanes until each is done or out of the slab
           (a local loop, no collective inside)
        -> ship: every resident lane whose owner (``_owner``: wrapped x,
           clamped to the edge slabs) is another rank moves one hop toward
           it, as a masked exchange of the full-width state (``ppermute``
           right, then left)
        -> the count of active lanes, summed over both mesh axes, decides
           whether another round runs, so every rank runs the same rounds
           and the sends and receives pair up.

At the end each lane's state is summed over the space axis with the other
ranks' rows zeroed (as int32 bit patterns, so every float comes back to the
bit), and shading runs on the assembled state as in ``render_rays_fast``.
The output is bit-equal to the single-device plain march; only the rank a
lane is marched on changes.

The march is PyTorch operations, as the reference's is XLA operations
(``fast._march_body``, not a Pallas kernel); a slab-bounded mode of the CUDA
march is a later item (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import fields

import torch

from ..config import RenderConfig
from ..render import fast, renderer
from ..render.camera import Camera, ray_directions
from ..render.renderer import _March
from .mesh import DATA_AXIS, SPACE_AXIS, Mesh
from .spatial import SpatialScene, _slab_cells, _slab_lookup

_INNER_CAP = 2048  # guard on one round's march iterations
_MAX_ROUNDS = 512  # guard on handoff rounds
_FIELDS = [f.name for f in fields(_March)]
# int32 words of one lane on the wire: the march state, then the ship mask
LANE_WORDS = 28 + 1
LANE_BYTES = 4 * LANE_WORDS


def _owner(cell_x, slab_w: int, n_space: int):
    """Space coordinate owning a cell: by wrapped x (the lookups wrap &1023),
    clamped so that addresses past the world (air everywhere) go to the edge
    slab."""
    return torch.clamp((cell_x & 1023) // slab_w, max=n_space - 1)


def _slab_gather_enc(sscene: SpatialScene, cell):
    """``fast._gather_enc`` against this rank's slab: the world's value for
    every cell the rank owns; 129 (air, the least licence) elsewhere."""
    local, lin = _slab_cells(sscene, cell)
    v = torch.take(sscene.slab.grid_enc, lin).to(torch.int32)
    return torch.where(local, v, torch.full_like(v, 129))


def _pack(s: _March) -> torch.Tensor:
    """The state as int32 [N, 28]: floats as their bit patterns, bools as 0/1."""
    cols = []
    for name in _FIELDS:
        x = getattr(s, name)
        x = x.reshape(x.shape[0], -1)
        if x.dtype == torch.float32:
            x = x.contiguous().view(torch.int32)
        cols.append(x.to(torch.int32))
    return torch.cat(cols, dim=1)


def _unpack(w: torch.Tensor, like: _March) -> _March:
    out, i = {}, 0
    for name in _FIELDS:
        x = getattr(like, name)
        k = x[0].numel() if x.ndim > 1 else 1
        col = w[:, i:i + k].contiguous()
        i += k
        if x.dtype == torch.float32:
            col = col.view(torch.float32)
        elif x.dtype == torch.bool:
            col = col != 0
        out[name] = col.reshape(x.shape)
    return _March(**out)


def _select(mask, a: _March, b: _March) -> _March:
    """Per lane: ``a`` where ``mask``, else ``b``."""
    out = {}
    for name in _FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        out[name] = torch.where(mask.reshape(mask.shape + (1,) * (x.ndim - 1)), x, y)
    return _March(**out)


def _handoff_march(sscene: SpatialScene, mesh: Mesh, state: _March, resident, cfg: RenderConfig,
                   budget: int, shadow: bool, time_s):
    """The round loop; returns (the assembled final state, the same on every
    space rank; stats). ``state`` must be the same on every space rank on
    entry; ``resident`` is this rank's ownership mask."""
    n_space = mesh.n_space
    slab_w = sscene.slab_w
    idx = mesh.axis_index(SPACE_AXIS)
    both = (DATA_AXIS, SPACE_AXIS)

    def owner(s):
        return _owner(s.cell[:, 0], slab_w, n_space)

    def inner(s, res):
        for _ in range(_INNER_CAP):
            loc = res & ~s.done & (owner(s) == idx)
            if not bool(loc.any()):
                break
            enc = _slab_gather_enc(sscene, s.cell)
            s2 = fast._march_body(sscene.slab, s._replace(done=s.done | ~loc), enc, cfg, budget,
                                  shadow, time_s, shape3=sscene.shape3)
            s = s2._replace(done=torch.where(loc, s2.done, s.done))
        return s

    def ship(s, res):
        own = owner(s)
        move = res & ~s.done & (own != idx)
        send_r = move & (own > idx)
        send_l = move & (own < idx)
        res = res & ~(send_r | send_l)
        if n_space > 1:
            packed = _pack(s)
            for send, shift in ((send_r, 1), (send_l, -1)):
                got = mesh.ppermute(torch.cat([send.to(torch.int32)[:, None], packed], dim=1),
                                    SPACE_AXIS, shift)
                came = got[:, 0] > 0
                s = _select(came, _unpack(got[:, 1:], s), s)
                res = res | came
        return s, res, (send_r | send_l).sum()

    def g_active(s, res):
        # summed over both axes: every rank runs the same rounds, or the
        # sends and receives of the exchange would not pair up
        return int(mesh.psum((res & ~s.done).sum().to(torch.int32), both))

    s, res = state, resident
    shipped = torch.zeros((), dtype=torch.int64, device=resident.device)
    n_act, rounds = g_active(s, res), 0
    while rounds < _MAX_ROUNDS and n_act > 0:
        s = inner(s, res)
        s, res, k = ship(s, res)
        shipped += k
        n_act, rounds = g_active(s, res), rounds + 1
    # the full-width exchange: a rank sends right and left, but for the edges
    sends = int(idx < n_space - 1) + int(idx > 0) if n_space > 1 else 0
    wire = torch.tensor([rounds * sends * res.shape[0] * LANE_BYTES], dtype=torch.int64,
                        device=resident.device)
    lanes = int(mesh.psum(shipped.reshape(1), both))
    stats = {"rounds": rounds, "lanes_shipped": lanes, "bytes_shipped": lanes * LANE_BYTES,
             "wire_bytes": int(mesh.psum(wire, both))}
    # assemble: exactly one rank is resident for each lane
    rows = torch.where(res[:, None], _pack(s), torch.zeros((), dtype=torch.int32,
                                                           device=res.device))
    return _unpack(mesh.psum(rows, SPACE_AXIS), s), stats


@torch.no_grad()
def render_rays_handoff(sscene: SpatialScene, origin, dirs, cfg: RenderConfig, mesh: Mesh,
                        return_stats: bool = False):
    """The full-feature fast-path render over a spatially sharded world with
    ray handoff: this rank's block of ``dirs`` (split over the data axis).
    Returns its rgb [N / n_data, 3], and with ``return_stats`` the primary
    march's ``rounds``, ``lanes_shipped``, ``bytes_shipped`` (lanes times
    ``LANE_BYTES``, the bytes one lane takes on the wire) and ``wire_bytes``
    (what the full-width exchange sent). Hemisphere AO runs through the
    collective slab lookup (one sum per AO step; its budget is only
    ao_rays x ao_steps)."""
    f32 = torch.float32
    dev = mesh.device
    if sscene.shape3[0] != sscene.slab_w * mesh.n_space:
        raise ValueError(f"{sscene.slab_w}-wide slabs on {mesh.n_space} space ranks do not "
                         f"cover x extent {sscene.shape3[0]}")
    origin = torch.as_tensor(origin, dtype=f32, device=dev)
    dirs = mesh.block(torch.as_tensor(dirs, dtype=f32, device=dev))
    N = dirs.shape[0]
    scene = sscene.slab
    sun = torch.from_numpy(fast.sun_unit(cfg.sun_dir)).to(dev)
    idx = mesh.axis_index(SPACE_AXIS)

    def lookup(cell):
        return _slab_lookup(sscene, mesh, cell)

    # the start cell's specials (frag:299-307): one collective lookup
    s = fast._init_state(origin, dirs, torch.ones(N, dtype=f32, device=dev))
    s, raw0, mat0 = fast.start_cell(scene, s, lookup_fn=lookup)
    resident = _owner(s.cell[:, 0], sscene.slab_w, mesh.n_space) == idx
    s, stats = _handoff_march(sscene, mesh, s, resident, cfg, cfg.max_steps, False, cfg.time)

    def shadow_fn(p, cell, last_axis, step, active):
        return _shadow_handoff(sscene, mesh, p, cell, last_axis, cfg, sun, active)

    col, _ = renderer.shade(scene, s, raw0, mat0, sun, cfg, shadow_fn, ao_lookup_fn=lookup)
    return (col, stats) if return_stats else col


def _shadow_handoff(sscene: SpatialScene, mesh: Mesh, p, cell, last_axis, cfg, sun, active):
    """The sun-shadow march through the handoff rounds (the semantics of
    ``fast._shadow_march_fast``). Shadow rays start at the hit points, so
    their first owners are spread over the slabs."""
    s = fast.shadow_start(p, cell, last_axis, sun, active)
    resident = _owner(s.cell[:, 0], sscene.slab_w, mesh.n_space) == mesh.axis_index(SPACE_AXIS)
    s, _ = _handoff_march(sscene, mesh, s, resident, cfg, cfg.shadow_steps, True, None)
    return active & (s.mat != 0)


def render_image_handoff(sscene: SpatialScene, camera: Camera, cfg: RenderConfig, mesh: Mesh,
                         return_stats: bool = False):
    """A frame [H, W, 3] on every rank: ``render_rays_handoff`` on each data
    block, gathered over the data axis (and the stats, with
    ``return_stats``)."""
    dirs = ray_directions(camera, cfg.width, cfg.height, cfg.fov_degrees)
    col, stats = render_rays_handoff(sscene, camera.pos, dirs, cfg, mesh, return_stats=True)
    img = mesh.all_gather(col, DATA_AXIS).reshape(cfg.height, cfg.width, 3)
    return (img, stats) if return_stats else img
