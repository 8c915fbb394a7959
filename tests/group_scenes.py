"""Scenes for the two-level scan's tests (no JAX, so the ``cuda`` tests
import them on the card's machine)."""
import torch

from raytracingincuda_torch.models.camera import CameraConfig, initialize
from raytracingincuda_torch.models.scene import (Scene, build_scene,
                                                 param_leaves,
                                                 params_from_leaves)
from raytracingincuda_torch.ops import group_scan as gs
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops.intersect import hit_world

EYE = (13.0, 2.0, 3.0)  # the reference camera's centre


def groups_of(table) -> dict:
    """slot -> the index of its group in the table's order."""
    out = {}
    for g in range(table.n_groups):
        p = table.n_large + g * gs.GROUP
        for k in table.slot[p:p + gs.GROUP].tolist():
            if k >= 0:
                out[k] = g
    return out


def to_device(scene: Scene, device) -> Scene:
    params = params_from_leaves([t.to(device) for t in param_leaves(
        scene.params)])
    return Scene(params, scene.mat_type.to(device), scene.active.to(device))


def tie_scene(device="cpu"):
    """Scene 1, all lambertian, with one small sphere's centre and radius
    copied over another slot, which turns red: the two spheres tie exactly
    on every ray, and they sit in two groups, the higher slot's walked
    first from the reference camera. The copied sphere is one that many
    primary rays of a 64x40 render hit. Returns (scene, lower slot, higher
    slot)."""
    base = build_scene(1, device="cpu")
    cam_cfg = CameraConfig.reference_default()
    cam = rk.pack_camera(initialize(cam_cfg, 64, 40))
    leaves = param_leaves(base.params)
    small = [k for k in range(base.num_slots)
             if bool(base.active[k]) and float(leaves[3][k]) < 0.5]
    seen = torch.zeros(base.num_slots)
    first = []

    def primary(o, d, active):
        if not first:
            res = hit_world(base, o, d)
            first.append(1)
            seen.index_add_(0, res.idx[res.hit & active],
                            torch.ones(int((res.hit & active).sum())))

    rk.wave_rays(*rk.regen_inputs(base, cam_cfg, 64, 40, 1), primary,
                 samples=1, max_depth=1)
    small.sort(key=lambda k: -float(seen[k]))     # the most seen first
    for a in small[:60]:
        for b in small[-40:]:
            new = [t.clone() for t in leaves]
            for c in range(4):                     # centre x, y, z, radius
                new[c][b] = new[c][a]
            new[4][b], new[5][b], new[6][b] = 1.0, 0.0, 0.0
            scene = Scene(params_from_leaves(new),
                          torch.zeros_like(base.mat_type), base.active)
            sm = rk.pack_scene_matrix(scene)
            grp = groups_of(gs.unpack(gs.group_table_reference(sm, cam),
                                      sm.shape[0]))
            lo, hi = min(a, b), max(a, b)
            if lo in grp and hi in grp and grp[hi] < grp[lo]:
                return to_device(scene, device), lo, hi
    raise AssertionError("no slot pair straddles two groups")


def scene_named(name: str, device):
    """The scenes the kernels' two-level tests run: scene 1, the tie scene
    and 2000 random spheres (2048 slots, layout 'vmem')."""
    from raytracingincuda_torch.models.scene import build_random_scene

    if name == "cover":
        return build_scene(1, device=device)
    if name == "tie":
        return tie_scene(device)[0]
    return build_random_scene(2000, device=device)


def one_level(monkeypatch):
    """Make every launch scan in one level (no group table)."""
    monkeypatch.setattr(gs, "group_table", lambda *args: None)
