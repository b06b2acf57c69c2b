"""Isosurface extraction: vectorized marching tetrahedra (this package's
own copy of nicer_slam_tpu/ops/marching_cubes.py, numpy only).

Replaces the reference's skimage.measure.marching_cubes call
(utils/plots.py:128-135). Each grid cube is split into 6 tetrahedra; each
tetrahedron contributes 0-2 triangles depending on its 4 corner signs. The
case tables are tiny and derived here from first principles (unlike MC33's
256-case table), and the whole extraction is vectorized numpy — the SDF
grid itself is evaluated on-device in chunks by the caller.

Output matches the reference contract: vertices in world coords, faces,
per-vertex normals (from central-difference SDF gradients on the grid).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

# 6-tetrahedra decomposition of a cube (corner ids 0..7 with bit layout
# x=bit0, y=bit1, z=bit2); all six share the main diagonal 0-7.
_TETS = np.array([
    [0, 5, 1, 7],
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
], np.int32)

_CUBE_CORNERS = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.int32)

# tetra case table: for sign bitmask (bit i set = corner i inside), list of
# triangles as pairs of corner indices (edges) to interpolate. Built once.
def _build_tet_table():
    table = [[] for _ in range(16)]
    # edges of a tet (pairs of local corner ids)
    for mask in range(16):
        inside = [i for i in range(4) if (mask >> i) & 1]
        outside = [i for i in range(4) if not (mask >> i) & 1]
        if len(inside) == 0 or len(inside) == 4:
            continue
        if len(inside) == 1:
            a = inside[0]
            b, c, d = outside
            table[mask] = [[(a, b), (a, c), (a, d)]]
        elif len(inside) == 3:
            a = outside[0]
            b, c, d = inside
            table[mask] = [[(a, b), (a, d), (a, c)]]
        else:  # 2-2: quad -> two triangles
            a, b = inside
            c, d = outside
            table[mask] = [[(a, c), (b, c), (b, d)],
                           [(a, c), (b, d), (a, d)]]
    return table


_TET_TABLE = _build_tet_table()


def marching_tetrahedra(volume: np.ndarray, level: float = 0.0,
                        spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                        origin: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                        valid: "np.ndarray | None" = None):
    """Extract the ``level`` isosurface of ``volume`` [Nx,Ny,Nz].

    ``valid`` (optional bool [Nx,Ny,Nz]) marks observed voxels: cubes with
    any unobserved corner are skipped (TSDF fusion uses this to suppress
    phantom shells at observation boundaries).

    Returns (verts [V,3], faces [F,3], normals [V,3]). Vertices are
    deduplicated per interpolated edge. Normals are the negative normalized
    central-difference gradient interpolated at the vertices (pointing
    toward lower values, i.e. outward when inside>level)."""
    vol = np.asarray(volume, np.float32) - level
    Nx, Ny, Nz = vol.shape
    nx, ny, nz = Nx - 1, Ny - 1, Nz - 1

    # collect active cubes (sign change among corners) to bound work
    inside = vol > 0
    c = inside[:-1, :-1, :-1]
    any_in = np.zeros((nx, ny, nz), bool)
    all_in = np.ones((nx, ny, nz), bool)
    all_valid = np.ones((nx, ny, nz), bool)
    for dx, dy, dz in _CUBE_CORNERS:
        s = inside[dx:dx + nx, dy:dy + ny, dz:dz + nz]
        any_in |= s
        all_in &= s
        if valid is not None:
            all_valid &= valid[dx:dx + nx, dy:dy + ny, dz:dz + nz]
    active = np.argwhere(any_in & ~all_in & all_valid)  # [A,3]
    if active.shape[0] == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
                np.zeros((0, 3), np.float32))

    base = active[:, None, :]                              # [A,1,3]
    corner_xyz = base + _CUBE_CORNERS[None, :, :]          # [A,8,3]
    cv = vol[corner_xyz[..., 0], corner_xyz[..., 1], corner_xyz[..., 2]]

    # gather per-tet corner coords/values: [A,6,4,...]
    tet_xyz = corner_xyz[:, _TETS, :]                      # [A,6,4,3]
    tet_val = cv[:, _TETS]                                 # [A,6,4]
    A = tet_xyz.shape[0]
    tet_xyz = tet_xyz.reshape(A * 6, 4, 3)
    tet_val = tet_val.reshape(A * 6, 4)

    mask = ((tet_val > 0) * np.array([1, 2, 4, 8])).sum(-1)  # [T]

    tris_e0, tris_e1, tris_e2 = [], [], []  # each: [K,2,?] edge corner ids
    tet_ids = []
    for m in range(1, 15):
        tris = _TET_TABLE[m]
        sel = np.where(mask == m)[0]
        if sel.size == 0 or not tris:
            continue
        for tri in tris:
            tet_ids.append(sel)
            tris_e0.append(np.asarray(tri[0]))
            tris_e1.append(np.asarray(tri[1]))
            tris_e2.append(np.asarray(tri[2]))
    if not tet_ids:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
                np.zeros((0, 3), np.float32))

    def interp(sel, edge):
        a, b = edge
        pa = tet_xyz[sel, a].astype(np.float64)
        pb = tet_xyz[sel, b].astype(np.float64)
        va = tet_val[sel, a].astype(np.float64)
        vb = tet_val[sel, b].astype(np.float64)
        t = va / (va - vb + 1e-30)
        return pa + t[:, None] * (pb - pa)

    tri_pts = []
    for sel, e0, e1, e2 in zip(tet_ids, tris_e0, tris_e1, tris_e2):
        p0 = interp(sel, e0)
        p1 = interp(sel, e1)
        p2 = interp(sel, e2)
        tri_pts.append(np.stack([p0, p1, p2], axis=1))     # [K,3,3]
    tri_pts = np.concatenate(tri_pts, axis=0)              # [F,3,3] grid coords

    # deduplicate vertices (quantized grid coords are exact on edges)
    flat = tri_pts.reshape(-1, 3)
    keys = np.round(flat * 1024.0).astype(np.int64)
    uniq, idx = np.unique(keys, axis=0, return_inverse=True)
    # representative coordinates: first occurrence per unique key
    seen = np.full(uniq.shape[0], flat.shape[0], np.int64)
    order = np.arange(flat.shape[0])
    np.minimum.at(seen, idx, order)
    verts_grid = flat[seen]
    faces = idx.reshape(-1, 3)

    # drop degenerate faces
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    faces = faces[good]

    # normals: central differences of the volume at vertex positions
    gx, gy, gz = np.gradient(vol)
    vi = np.clip(verts_grid, 0, np.array([Nx, Ny, Nz]) - 1.001)
    i0 = np.floor(vi).astype(np.int64)
    f = vi - i0
    i1 = np.minimum(i0 + 1, np.array([Nx, Ny, Nz]) - 1)

    def trilerp(g):
        c000 = g[i0[:, 0], i0[:, 1], i0[:, 2]]
        c100 = g[i1[:, 0], i0[:, 1], i0[:, 2]]
        c010 = g[i0[:, 0], i1[:, 1], i0[:, 2]]
        c110 = g[i1[:, 0], i1[:, 1], i0[:, 2]]
        c001 = g[i0[:, 0], i0[:, 1], i1[:, 2]]
        c101 = g[i1[:, 0], i0[:, 1], i1[:, 2]]
        c011 = g[i0[:, 0], i1[:, 1], i1[:, 2]]
        c111 = g[i1[:, 0], i1[:, 1], i1[:, 2]]
        fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
        c00 = c000 * (1 - fx) + c100 * fx
        c10 = c010 * (1 - fx) + c110 * fx
        c01 = c001 * (1 - fx) + c101 * fx
        c11 = c011 * (1 - fx) + c111 * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        return c0 * (1 - fz) + c1 * fz

    normals = np.stack([trilerp(gx), trilerp(gy), trilerp(gz)], -1)
    normals = -normals  # point from inside (positive) outward
    normals /= (np.linalg.norm(normals, axis=-1, keepdims=True) + 1e-12)

    sp = np.asarray(spacing, np.float64)
    org = np.asarray(origin, np.float64)
    verts = (verts_grid * sp + org).astype(np.float32)
    return verts, faces.astype(np.int64), normals.astype(np.float32)


def extract_mesh(
    sdf_fn: Callable[[np.ndarray], np.ndarray],
    resolution: int = 512,
    grid_boundary: Tuple[float, float] = (-1.0, 1.0),
    level: float = 0.0,
    chunk: int = 262144,
):
    """Evaluate an SDF on a uniform grid (chunked; sdf_fn may run on
    device) and extract the level-set mesh — the get_surface_trace
    equivalent (utils/plots.py:102-155)."""
    lo, hi = grid_boundary
    xs = np.linspace(lo, hi, resolution, dtype=np.float32)
    step = xs[1] - xs[0]
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    vals = np.empty((grid.shape[0],), np.float32)
    for s in range(0, grid.shape[0], chunk):
        e = min(s + chunk, grid.shape[0])
        vals[s:e] = np.asarray(sdf_fn(grid[s:e])).reshape(-1)
    vol = vals.reshape(resolution, resolution, resolution)
    if vol.min() > level or vol.max() < level:
        return None
    return marching_tetrahedra(vol, level=level, spacing=(step,) * 3,
                               origin=(lo, lo, lo))
