"""σ-field → triangle mesh extraction and export.

Port of gbnerf_tpu/utils/mesh.py. The host-side numpy is a copy of the JAX
package's: ``density_grid``, marching tetrahedra (``_TETS``,
``_emit_triangles``, ``_cross_rows``, ``marching_tetrahedra``) and the
OBJ / PLY writers, so that the same grid gives bit-equal vertices and
faces. Each cube is split into the six tetrahedra that share its main
diagonal (v0–v7); the split is face-consistent, so the surface is
crack-free, and a crossing on a shared grid edge is interpolated from the
same two grid values by every tetrahedron that holds it, so exact welding
(np.unique on rows) stitches the mesh. ``extract_field_mesh`` evaluates σ
on the field's device (``density_grid_on``: slabs of slab·R² points,
σ-only, without gradient: K2 for a CP field on the card) and the vertex
colours there too (K1), with one host copy a slab or batch.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

# Six tetrahedra sharing the main diagonal (corner bit k: bit0→x, bit1→y,
# bit2→z). Each is (0, a, a|b, 7) for one of the six axis orders a→b→c.
_TETS = np.array([
    (0, 1, 3, 7),   # x, y, z
    (0, 3, 2, 7),   # y, x, z
    (0, 2, 6, 7),   # y, z, x
    (0, 6, 4, 7),   # z, y, x
    (0, 4, 5, 7),   # z, x, y
    (0, 5, 1, 7),   # x, z, y
], np.int32)


def density_grid(sigma_fn: Callable, resolution: int,
                 bound_min: Sequence[float], bound_max: Sequence[float],
                 slab: int = 8) -> np.ndarray:
    """Evaluate σ on a regular [R, R, R] grid in fixed-size z-slabs.

    sigma_fn: [N, 3] numpy world points → [N] raw σ (pre-relu is fine;
    the iso threshold is applied to whatever this returns), called with
    [slab·R·R, 3] batches (the ragged last slab overlaps the one before).
    """
    r = resolution
    lo = np.asarray(bound_min, np.float32)
    hi = np.asarray(bound_max, np.float32)
    axes = [np.linspace(lo[a], hi[a], r, dtype=np.float32) for a in range(3)]
    out = np.empty((r, r, r), np.float32)
    for z0 in range(0, r, slab):
        z1 = min(z0 + slab, r)
        if z1 - z0 < slab and r > slab:   # keep the batch shape static
            z0 = r - slab
            z1 = r
        X, Y, Z = np.meshgrid(axes[0], axes[1], axes[2][z0:z1],
                              indexing="ij")
        pts = np.stack([X, Y, Z], -1).reshape(-1, 3)
        out[:, :, z0:z1] = np.asarray(sigma_fn(pts)).reshape(r, r, z1 - z0)
    return out


def _emit_triangles(vals, pos, iso):
    """Triangles for a batch of tetrahedra.

    vals [M, 4] corner σ; pos [M, 4, 3] corner positions. Returns
    [T, 3, 3] triangle vertices, oriented with normals pointing out of the
    σ>iso region.
    """
    inside = vals > iso                      # [M, 4]
    n_in = inside.sum(1)
    tris = []

    def orient(tri, inside_pt):
        """Flip triangles whose normal points toward the inside point."""
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        c = tri.mean(1)
        flip = np.einsum("ij,ij->i", n, inside_pt - c) > 0
        tri[flip] = tri[flip][:, [0, 2, 1]]
        return tri

    # one vertex on one side: single triangle (lone = the minority corner)
    for lone_inside in (True, False):
        k = 1 if lone_inside else 3
        m = np.nonzero(n_in == k)[0]
        if not len(m):
            continue
        lone = np.argmax(inside[m] == lone_inside, axis=1)
        others = np.array([[b for b in range(4) if b != a] for a in range(4)])
        oth = others[lone]                   # [m, 3]
        tri = np.stack([
            _cross_rows(vals, pos, m, lone, oth[:, i], iso)
            for i in range(3)], axis=1)      # [m, 3, 3]
        # inside reference point: the lone corner if it is inside, else the
        # centroid of the three inside corners ≈ any inside corner works
        ref = (pos[m, lone] if lone_inside
               else pos[m][np.arange(len(m))[:, None], oth].mean(1))
        tris.append(orient(tri, ref))

    # two/two split: quad → two triangles
    m = np.nonzero(n_in == 2)[0]
    if len(m):
        ins = np.argsort(~inside[m], axis=1)[:, :2]    # inside corners A,B
        outs = np.argsort(inside[m], axis=1)[:, :2]    # outside corners C,D
        A, B = ins[:, 0], ins[:, 1]
        C, D = outs[:, 0], outs[:, 1]
        ac = _cross_rows(vals, pos, m, A, C, iso)
        ad = _cross_rows(vals, pos, m, A, D, iso)
        bc = _cross_rows(vals, pos, m, B, C, iso)
        bd = _cross_rows(vals, pos, m, B, D, iso)
        ref = 0.5 * (pos[m, A] + pos[m, B])
        # non-crossing cycle ac → ad → bd → bc
        t1 = orient(np.stack([ac, ad, bd], 1), ref)
        t2 = orient(np.stack([ac, bd, bc], 1), ref)
        tris.extend([t1, t2])

    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    return np.concatenate(tris, 0)


def _cross_rows(vals, pos, m, a_idx, b_idx, iso):
    """Iso-crossing points on edges (a_idx[i], b_idx[i]) of tets m[i].

    Endpoints are canonicalized (smaller value first) so the SAME global
    grid edge interpolates to the BITWISE-same point from every tet that
    contains it — exact welding by np.unique then stitches without cracks.
    """
    rows = np.arange(len(m))
    va = vals[m][rows, a_idx]
    vb = vals[m][rows, b_idx]
    pa = pos[m][rows, a_idx]
    pb = pos[m][rows, b_idx]
    swap = va > vb
    va, vb = np.where(swap, vb, va), np.where(swap, va, vb)
    pa, pb = (np.where(swap[:, None], pb, pa),
              np.where(swap[:, None], pa, pb))
    t = (iso - va) / (vb - va)
    return (pa + t[:, None] * (pb - pa)).astype(np.float32)


def marching_tetrahedra(grid: np.ndarray, iso: float,
                        bound_min: Sequence[float] = (0.0, 0.0, 0.0),
                        bound_max: Sequence[float] = (1.0, 1.0, 1.0),
                        layer_chunk: int = 8
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a [RX, RY, RZ] scalar grid.

    Returns (verts [V, 3] world coords, faces [F, 3] int indices), welded.
    """
    g = np.asarray(grid, np.float32)
    rx, ry, rz = g.shape
    lo = np.asarray(bound_min, np.float32)
    hi = np.asarray(bound_max, np.float32)
    axes = [np.linspace(lo[a], hi[a], n, dtype=np.float32)
            for a, n in enumerate(g.shape)]

    all_tris = []
    # process cube layers in z-chunks to bound peak memory
    for z0 in range(0, rz - 1, layer_chunk):
        z1 = min(z0 + layer_chunk, rz - 1)
        nz = z1 - z0
        # corner grids for cubes in this chunk: [rx-1, ry-1, nz, 8]
        vals = np.empty((rx - 1, ry - 1, nz, 8), np.float32)
        pos = np.empty((rx - 1, ry - 1, nz, 8, 3), np.float32)
        for k in range(8):
            dx, dy, dz = k & 1, (k >> 1) & 1, (k >> 2) & 1
            vals[..., k] = g[dx:rx - 1 + dx, dy:ry - 1 + dy,
                             z0 + dz:z1 + dz]
            pos[..., k, 0] = axes[0][dx:rx - 1 + dx][:, None, None]
            pos[..., k, 1] = axes[1][dy:ry - 1 + dy][None, :, None]
            pos[..., k, 2] = axes[2][z0 + dz:z1 + dz][None, None, :]
        vals = vals.reshape(-1, 8)
        pos = pos.reshape(-1, 8, 3)
        # skip cubes entirely in/out
        ins = vals > iso
        active = np.nonzero((ins.any(1)) & (~ins.all(1)))[0]
        if not len(active):
            continue
        vals, pos = vals[active], pos[active]
        tet_vals = vals[:, _TETS].reshape(-1, 4)          # [6·A, 4]
        tet_pos = pos[:, _TETS].reshape(-1, 4, 3)
        all_tris.append(_emit_triangles(tet_vals, tet_pos, iso))

    if not all_tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tris = np.concatenate(all_tris, 0)                    # [T, 3, 3]
    # drop degenerate (zero-area) triangles from corners exactly at iso
    area2 = np.linalg.norm(
        np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]), axis=1)
    tris = tris[area2 > 0]
    flat = tris.reshape(-1, 3)
    verts, inv = np.unique(flat, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    return verts.astype(np.float32), faces


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# gbnerf_tpu mesh export\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces + 1:          # OBJ is 1-indexed
            f.write(f"f {a} {b} {c}\n")


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY; optional per-vertex uint8 RGB colors."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n_v, n_f = len(verts), len(faces)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n_v}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += [f"element face {n_f}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if colors is None:
            f.write(np.ascontiguousarray(verts, "<f4").tobytes())
        else:
            vdt = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec = np.empty(n_v, vdt)
            rec["xyz"] = verts
            rec["rgb"] = colors
            f.write(rec.tobytes())
        fdt = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
        rec = np.empty(n_f, fdt)
        rec["n"] = 3
        rec["idx"] = faces
        f.write(rec.tobytes())


def density_grid_on(sigma_fn: Callable, resolution: int,
                    bound_min: Sequence[float], bound_max: Sequence[float],
                    slab: int = 8, device=None) -> np.ndarray:
    """``density_grid`` with the points made on ``device``: σ of a regular
    [R, R, R] grid in z-slabs of slab·R² points, each slab one call of
    sigma_fn ([N, 3] tensor → [N]) and one copy to the host. The grid's
    axes are ``density_grid``'s float32 linspaces, so both evaluate σ at
    the same points."""
    r = resolution
    lo = np.asarray(bound_min, np.float32)
    hi = np.asarray(bound_max, np.float32)
    axes = [torch.from_numpy(np.linspace(lo[a], hi[a], r, dtype=np.float32)
                             ).to(device) for a in range(3)]
    out = np.empty((r, r, r), np.float32)
    for z0 in range(0, r, slab):
        z1 = min(z0 + slab, r)
        if z1 - z0 < slab and r > slab:   # the ragged tail: one batch shape
            z0, z1 = r - slab, r
        X, Y, Z = torch.meshgrid(axes[0], axes[1], axes[2][z0:z1],
                                 indexing="ij")
        pts = torch.stack([X, Y, Z], -1).reshape(-1, 3)
        out[:, :, z0:z1] = sigma_fn(pts).reshape(r, r, z1 - z0).cpu().numpy()
    return out


def extract_field_mesh(field_fn: Callable, *, resolution: int = 128,
                       bound: float | Sequence[float] = 1.0,
                       iso: float = 10.0, color: bool = False,
                       batch: int | None = None, device=None,
                       times: dict | None = None):
    """Field → density grid → welded mesh.

    field_fn(pts [N, S, 3], viewdirs [N, 3] | None, sigma_only) → raw
    [N, S, 4], the make_field_fn contract, on ``device`` (default the
    card, as every entry point of the port: an error without one; pass
    ``device="cpu"`` for the CPU). ``bound`` is a scalar half-width (the
    grid spans [−b, b]³) or (lo, hi). iso is the raw-σ threshold
    (stable-dreamfusion's density_thresh is 10). Without gradient
    throughout.

    Returns (verts, faces[, colors uint8]): with color=True each vertex's
    colour is the field's at the vertex, seen along the inward vertex
    normal, in batches of ``batch`` (65,536) vertices. ``times``, where
    given, receives the seconds of the σ grid, the triangulation and the
    colours (``grid_s``, ``triangulate_s``, ``color_s``; each part ends in
    a copy to the host).
    """
    if device is None:
        from ..train.loop import default_device

        device = default_device()
    device = torch.device(device)
    if np.isscalar(bound):
        lo, hi = (-float(bound),) * 3, (float(bound),) * 3
    else:
        lo, hi = bound

    def sigma(pts):
        return field_fn(pts[:, None, :], None, sigma_only=True)[:, 0, 3]

    times = {} if times is None else times
    t0 = time.perf_counter()
    with torch.no_grad():
        grid = density_grid_on(sigma, resolution, lo, hi, device=device)
    times["grid_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts, faces = marching_tetrahedra(grid, iso, lo, hi)
    times["triangulate_s"] = time.perf_counter() - t0
    if not color:
        return verts, faces
    if len(verts) == 0:
        return verts, faces, np.zeros((0, 3), np.uint8)

    # area-weighted vertex normals; the view looks at the surface from
    # outside, along −normal
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)

    t0 = time.perf_counter()
    bs = batch or 65536
    cols = np.empty((len(verts), 3), np.float32)
    with torch.no_grad():
        for i0 in range(0, len(verts), bs):
            v = torch.from_numpy(verts[i0:i0 + bs]).to(device)
            d = torch.from_numpy(-vn[i0:i0 + bs]).to(device)
            raw = field_fn(v[:, None, :], d, sigma_only=False)
            cols[i0:i0 + len(v)] = torch.sigmoid(raw[:, 0, :3]).cpu().numpy()
    times["color_s"] = time.perf_counter() - t0
    return verts, faces, (np.clip(cols, 0, 1) * 255).astype(np.uint8)
