"""Port vs JAX: mesh export (utils/mesh.py) and its CLI.

The triangulation and the writers are the JAX package's numpy, copied:
on the same grid the vertices and faces are bit-equal, and the files are
byte-equal. ``extract_field_mesh`` evaluates σ through the field on its
device; on converted CP fields its grid is held to the JAX package's at
the field tolerance (rtol 3e-2, atol 5e-3·max|σ|: both round every matmul
operand to bf16 but sum in another order).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gbnerf_tpu.config import Config, FieldConfig
from gbnerf_tpu.core.fields import make_field_fn as j_make_field_fn
from gbnerf_tpu.train.state import create_train_state
from gbnerf_tpu.utils import mesh as jmesh
from gbnerf_tpu_torch import convert
from gbnerf_tpu_torch.core.fields import make_field_fn as t_make_field_fn
from gbnerf_tpu_torch.train.state import create_params
from gbnerf_tpu_torch.utils import mesh as tmesh

torch.set_num_threads(1)
R_SPHERE = 0.6


def _sphere_grid(res=48, bound=1.0):
    ax = np.linspace(-bound, bound, res, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    return R_SPHERE - np.sqrt(X ** 2 + Y ** 2 + Z ** 2)


@pytest.mark.parametrize("case", ["sphere", "seeded", "seeded_chunks"])
def test_marching_tetrahedra_bit_equal_to_jax(rng, case):
    if case == "sphere":
        grid, iso, lo, hi, kw = (_sphere_grid(48), 0.0, (-1.0,) * 3,
                                 (1.0,) * 3, {})
    else:
        grid = rng.standard_normal((9, 12, 19)).astype(np.float32)
        iso, lo, hi = 0.3, (-1.0, -0.5, 0.0), (2.0, 1.5, 3.0)
        kw = {"layer_chunk": 5} if case == "seeded_chunks" else {}
    verts, faces = tmesh.marching_tetrahedra(grid, iso, lo, hi, **kw)
    jverts, jfaces = jmesh.marching_tetrahedra(grid, iso, lo, hi, **kw)
    assert verts.dtype == jverts.dtype and faces.dtype == jfaces.dtype
    assert len(faces) > 100
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    if case == "sphere":
        r = np.linalg.norm(verts, axis=1)
        np.testing.assert_array_less(np.abs(r - R_SPHERE), 2.0 / 47)
    for fill in (-1.0, 1.0):
        v, f = tmesh.marching_tetrahedra(np.full((6, 6, 6), fill,
                                                 np.float32), 0.0)
        assert len(v) == len(f) == 0


def test_density_grids_match_jax_point_for_point():
    """density_grid (numpy, copied) and density_grid_on (the points made on
    the device) evaluate at the JAX package's points, the ragged last slab
    included."""
    lo, hi = (-1.0, -0.5, 0.25), (1.0, 0.75, 2.0)
    for k in range(3):
        def np_fn(p, k=k):
            return np.asarray(p)[:, k] * 3.0 - 1.0

        ref = jmesh.density_grid(np_fn, 13, lo, hi, slab=4)
        np.testing.assert_array_equal(
            tmesh.density_grid(np_fn, 13, lo, hi, slab=4), ref)
        got = tmesh.density_grid_on(lambda p, k=k: p[:, k] * 3.0 - 1.0, 13,
                                    lo, hi, slab=4, device="cpu")
        np.testing.assert_array_equal(got, ref)


def _cp_fields():
    cfg = Config(field=FieldConfig(cp_resolutions=(5, 9, 17), cp_rank=4,
                                   cp_bound=1.5))
    state, jc, jf = create_train_state(cfg, jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    tc, tf = create_params(cfg, torch.Generator().manual_seed(0))
    convert.load_jax_params(tf, params["fine"])
    return j_make_field_fn(jf, state.params["fine"]), t_make_field_fn(tf)


def test_extract_field_mesh_cp_grid_matches_jax():
    jfn, tfn = _cp_fields()
    res, b = 20, 1.2

    @jax.jit
    def jsigma(pts):
        return jfn(jnp.asarray(pts)[:, None, :], None, sigma_only=True)[:, 0,
                                                                         3]

    ref = jmesh.density_grid(jsigma, res, (-b,) * 3, (b,) * 3)
    with torch.no_grad():
        got = tmesh.density_grid_on(
            lambda p: tfn(p[:, None, :], None, sigma_only=True)[:, 0, 3],
            res, (-b,) * 3, (b,) * 3, device="cpu")
    atol = 5e-3 * float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=3e-2, atol=atol)
    iso = float(np.median(ref))
    times = {}
    verts, faces, cols = tmesh.extract_field_mesh(
        tfn, resolution=res, bound=b, iso=iso, color=True, batch=500,
        times=times)
    assert set(times) == {"grid_s", "triangulate_s", "color_s"}
    # the port's mesh is marching tetrahedra of the port's grid, and close
    # to the JAX package's mesh of its own grid
    v2, f2 = tmesh.marching_tetrahedra(got, iso, (-b,) * 3, (b,) * 3)
    np.testing.assert_array_equal(verts, v2)
    np.testing.assert_array_equal(faces, f2)
    jverts, jfaces, jcols = jmesh.extract_field_mesh(
        jfn, resolution=res, bound=b, iso=iso, color=True, batch=500)
    assert abs(len(faces) - len(jfaces)) <= 0.05 * len(jfaces)
    assert cols.shape == (len(verts), 3) and cols.dtype == np.uint8
    # colours at the vertices both meshes share
    common, ti, ji = np.intersect1d(
        verts.view([("", verts.dtype)] * 3).ravel(),
        jverts.view([("", jverts.dtype)] * 3).ravel(), return_indices=True)
    assert len(common) > 0.5 * len(jverts)
    assert np.abs(cols[ti].astype(int) - jcols[ji]).max() <= 3


def test_extract_field_mesh_analytic_sphere():
    """The JAX test's analytic field: every vertex within a cell of the
    sphere, +x redder than −x, the vertex colours batched."""
    def field_fn(pts, viewdirs, sigma_only=False):
        d = torch.linalg.norm(pts, dim=-1)
        return torch.cat([pts, (40.0 * (R_SPHERE - d))[..., None]], dim=-1)

    verts, faces, cols = tmesh.extract_field_mesh(
        field_fn, resolution=24, bound=1.0, iso=0.0, color=True, batch=512)
    assert len(verts) > 100 and cols.shape == (len(verts), 3)
    r = np.linalg.norm(verts, axis=1)
    np.testing.assert_array_less(np.abs(r - R_SPHERE), 2.0 / 23)
    red = cols[:, 0].astype(np.float32)
    assert red[verts[:, 0] > 0.3].mean() > red[verts[:, 0] < -0.3].mean()
    v, f = tmesh.extract_field_mesh(field_fn, resolution=8, bound=1.0,
                                    iso=100.0)
    assert len(v) == len(f) == 0


def _read_ply(path):
    blob = open(path, "rb").read()
    end = blob.index(b"end_header\n") + len(b"end_header\n")
    hdr = blob[:end].decode().splitlines()
    n_v = int(next(l for l in hdr if l.startswith("element vertex")).split()[-1])
    n_f = int(next(l for l in hdr if l.startswith("element face")).split()[-1])
    colored = "property uchar red" in hdr
    vdt = (np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)]) if colored
           else np.dtype([("xyz", "<f4", 3)]))
    v = np.frombuffer(blob, vdt, n_v, end)
    f = np.frombuffer(blob, np.dtype([("n", "u1"), ("idx", "<i4", 3)]), n_f,
                      end + n_v * vdt.itemsize)
    return (v["xyz"], f["idx"], v["rgb"] if colored else None, f["n"])


def test_obj_and_ply_round_trip_byte_equal_to_jax(tmp_path, rng):
    verts, faces = tmesh.marching_tetrahedra(_sphere_grid(16), 0.0,
                                             (-1.0,) * 3, (1.0,) * 3)
    cols = (rng.random((len(verts), 3)) * 255).astype(np.uint8)
    for name, fn, args in (("m.obj", "write_obj", ()),
                           ("m.ply", "write_ply", ()),
                           ("c.ply", "write_ply", (cols,))):
        getattr(tmesh, fn)(str(tmp_path / "t" / name), verts, faces, *args)
        getattr(jmesh, fn)(str(tmp_path / "j" / name), verts, faces, *args)
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    vs, fs = [], []
    for line in open(tmp_path / "t" / "m.obj"):
        p = line.split()
        if p and p[0] == "v":
            vs.append([float(x) for x in p[1:4]])
        elif p and p[0] == "f":
            fs.append([int(x) - 1 for x in p[1:4]])
    np.testing.assert_allclose(np.array(vs, np.float32), verts, atol=1e-5)
    np.testing.assert_array_equal(np.array(fs), faces)
    v, f, c, n = _read_ply(str(tmp_path / "t" / "c.ply"))
    np.testing.assert_array_equal(v, verts)
    np.testing.assert_array_equal(f, faces)
    np.testing.assert_array_equal(c, cols)
    assert (n == 3).all()
    v, f, c, _ = _read_ply(str(tmp_path / "t" / "m.ply"))
    np.testing.assert_array_equal(v, verts)
    assert c is None


def test_export_mesh_cli_on_cpu(tmp_path):
    """A tiny stage-1 run through train(), then the CLI restores its
    checkpoint and writes a coloured PLY (and an OBJ) of the fine field;
    an iso the grid never crosses exits with the JAX tool's message; the
    card's default device exits without a card."""
    from gbnerf_tpu_torch.config import load_reference_config
    from gbnerf_tpu_torch.tools import export_mesh
    from gbnerf_tpu_torch.train import loop as tloop
    from gbnerf_tpu_torch.train.checkpoint import CheckpointManager

    cfg_path = tmp_path / "cfg.txt"
    cfg_path.write_text("\n".join([
        "expname = mesh", f"basedir = {tmp_path / 'logs'}",
        "cp_resolutions = 5,9,17", "cp_rank = 4", "cp_bound = 1.5",
        "N_rand = 32", "N_samples = 8", "N_importance = 8", "no_ndc = True",
        "white_bkgd = True", "first_stage = True", "N_iters = 2",
        "i_print = 1000", "i_weights = 2", "i_video = 1000",
        "i_evaluate = 1000", "i_testset = 1000"]) + "\n")
    cfg = load_reference_config(str(cfg_path))
    H, W = 8, 10
    rng = np.random.default_rng(0)
    from gbnerf_tpu_torch.data.llff import LLFFScene

    pose = np.concatenate([np.eye(3, 4, dtype=np.float32),
                           np.array([[H], [W], [9.0]], np.float32)], 1)
    pose[2, 3] = 2.5
    scene = LLFFScene(
        images=rng.random((2, H, W, 3)).astype(np.float32),
        masks=np.zeros((2, H, W), np.float32),
        inpainted_depths=np.zeros((2, H, W), np.float32),
        poses=np.stack([pose, pose]), poses_test=pose[None],
        bds=np.array([[1.0, 4.0]], np.float32), render_poses=pose[None],
        hwf=(H, W, 9.0), near=1.0, far=4.0)
    tloop.train(cfg, scene=scene, device="cpu", log_fn=lambda i, m: None)
    exp = tmp_path / "logs" / "mesh"
    assert CheckpointManager(str(exp / "ckpt")).latest_step() == 2
    # an iso inside the field's σ range
    from gbnerf_tpu_torch.train.state import create_train_state as tcreate

    state, _, fine = tcreate(cfg, torch.Generator(), "cpu")
    CheckpointManager(str(exp / "ckpt")).restore(state)
    with torch.no_grad():
        grid = tmesh.density_grid_on(
            lambda p: fine(p[:, None, :], None, sigma_only=True)[:, 0, 3],
            16, (-1.5,) * 3, (1.5,) * 3, device="cpu")
    iso = str(float(np.median(grid)))
    out = export_mesh.main(["--config", str(cfg_path), "--res", "16",
                            "--iso", iso, "--bound", "1.5", "--color",
                            "--device", "cpu"])
    assert out["out"] == str(exp / "mesh_000002.ply") and out["step"] == 2
    v, f, c, _ = _read_ply(out["out"])
    assert len(f) > 0 and c is not None
    np.testing.assert_array_equal(v, out["verts"])
    np.testing.assert_array_equal(c, out["colors"])
    obj = export_mesh.main(["--config", str(cfg_path), "--res", "16",
                            "--iso", iso, "--out", str(tmp_path / "m.obj"),
                            "--device", "cpu"])
    assert os.path.getsize(obj["out"]) > 0
    np.testing.assert_array_equal(obj["faces"], out["faces"])
    with pytest.raises(SystemExit, match="empty mesh"):
        export_mesh.main(["--config", str(cfg_path), "--res", "8",
                          "--iso", "1e9", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            export_mesh.main(["--config", str(cfg_path)])
