"""Port parity for the editing ops: trase_tpu_torch.editing and the
quaternion helpers against trase_tpu's on random unit quaternions and
random rotations (1e-6), and renderer.render_composite against
trase_tpu's (Pallas backend in interpret mode) at 64x64 with a ragged
background capacity, an object set, injected deformation deltas and a
non-trivial scale, rotation and motion bias (tests/test_torch_render.py's
TOL["render"])."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from trase_tpu import editing as JE
from trase_tpu.models import gaussians as JG
from trase_tpu.ops.rasterize import RasterConfig as JRasterConfig
from trase_tpu.renderer import RenderCamera as JRenderCamera
from trase_tpu.renderer import make_render_camera as j_camera
from trase_tpu.renderer import render_composite as j_render_composite
from trase_tpu.utils import quaternion as JQ

from trase_tpu_torch import editing as TE
from trase_tpu_torch.models import gaussians as TG
from trase_tpu_torch.ops.rasterize import RasterConfig as TRasterConfig
from trase_tpu_torch.renderer import make_render_camera as t_camera
from trase_tpu_torch.renderer import render_composite as t_render_composite
from trase_tpu_torch.utils import quaternion as TQ

torch.set_num_threads(2)

TOL = 1e-6
RENDER_TOL = 2e-4  # tests/test_torch_render.py's TOL["render"]


def unit_quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def rotations(n, seed):
    return Rotation.random(n, random_state=seed).as_matrix()


def close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_quaternion_helpers(seed):
    a, b = unit_quats(64, seed), unit_quats(64, seed + 10)
    close(TQ.normalize_quat(torch.tensor(3.0 * a)),
          JQ.normalize_quat(jnp.asarray(3.0 * a)))
    close(TQ.normalize_quat(torch.tensor(a), eps=0.5),
          JQ.normalize_quat(jnp.asarray(a), eps=0.5))
    close(TQ.quaternion_multiply(torch.tensor(a), torch.tensor(b)),
          JQ.quaternion_multiply(jnp.asarray(a), jnp.asarray(b)))
    # broadcasting one quaternion over a batch, in both operand orders
    close(TQ.quaternion_multiply(torch.tensor(a[0]), torch.tensor(b)),
          JQ.quaternion_multiply(jnp.asarray(a[0]), jnp.asarray(b)))
    close(TQ.quaternion_multiply(torch.tensor(b), torch.tensor(a[:1])),
          JQ.quaternion_multiply(jnp.asarray(b), jnp.asarray(a[:1])))
    for R in rotations(16, seed):
        q = TQ.rotmat_to_quat(R)
        np.testing.assert_array_equal(q, JQ.rotmat_to_quat(R))
        assert q[0] >= 0
        # the quaternion rotates as the matrix does
        close(TQ.build_rotation(torch.tensor(q[None], dtype=torch.float32))[0],
              R.astype(np.float32), 1e-5)


def gaussians(n, seed):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32)
    scales = rng.uniform(0.01, 0.2, size=(n, 3)).astype(np.float32)
    return means, unit_quats(n, seed + 1), scales


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_editing_ops(seed):
    means, quats, scales = gaussians(50, seed)
    tm, tq, ts = (torch.tensor(x) for x in (means, quats, scales))
    jm, jq, js = (jnp.asarray(x) for x in (means, quats, scales))
    for got, ref in zip(TE.rescale(tm, ts, 1.7), JE.rescale(jm, js, 1.7)):
        close(got, ref)
    R = rotations(1, seed)[0]
    for got, ref in zip(TE.rotate_by_matrix(tm, tq, R),
                        JE.rotate_by_matrix(jm, jq, R)):
        close(got, ref)
    angles = tuple(np.random.default_rng(seed).uniform(-3, 3, 3))
    for got, ref in zip(TE.rotate_by_euler_angles(tm, tq, angles),
                        JE.rotate_by_euler_angles(jm, jq, angles)):
        close(got, ref)
    # all-zero angles: the inputs come back as they are
    zm, zq = TE.rotate_by_euler_angles(tm, tq, (0.0, 0.0, 0.0))
    assert zm is tm and zq is tq
    close(TE.translation(tm, (0.3, -1.0, 2.5)),
          JE.translation(jm, (0.3, -1.0, 2.5)))
    for got, ref in zip(
            TE.transform_gaussians(tm, tq, ts, 0.6, (0.1, 0.2, -0.3), angles),
            JE.transform_gaussians(jm, jq, js, 0.6, jnp.asarray(
                (0.1, 0.2, -0.3)), angles)):
        close(got, ref)
    for ang in np.eye(3) * 0.4:  # one axis at a time
        ang = tuple(float(a) for a in ang)
        for got, ref in zip(TE.rotate_by_euler_angles(tm, tq, ang),
                            JE.rotate_by_euler_angles(jm, jq, ang)):
            close(got, ref)


def test_rotation_order_is_q_times_rotation():
    """The product's order shows only with non-identity rotations on both
    sides: hamilton(q_rot, rotation), not hamilton(rotation, q_rot)."""
    _, quats, _ = gaussians(8, 5)
    R = rotations(1, 9)[0]
    _, got = TE.rotate_by_matrix(torch.zeros(8, 3), torch.tensor(quats), R)
    q = torch.tensor(TQ.rotmat_to_quat(R), dtype=torch.float32)
    swapped = TQ.normalize_quat(TQ.quaternion_multiply(
        torch.tensor(quats), q.expand(8, 4)))
    assert (got - swapped).abs().max() > 1e-2
    # composing rotations: R applied after the gaussian's own rotation
    close(TQ.build_rotation(got), torch.tensor(R, dtype=torch.float32)
          @ TQ.build_rotation(torch.tensor(quats)), 1e-5)


def test_removal_and_selection_masks():
    ids = np.random.default_rng(3).integers(-1, 6, size=(97, 1))
    for sel in ([], [2], [0, 5, -1], [7]):
        np.testing.assert_array_equal(
            TE.selection_mask(torch.tensor(ids), sel).numpy(),
            np.asarray(JE.selection_mask(jnp.asarray(ids), sel)))
        np.testing.assert_array_equal(
            TE.removal_mask(torch.tensor(ids), sel).numpy(),
            np.asarray(JE.removal_mask(jnp.asarray(ids), sel)))


def field(n, capacity, seed, shift):
    """A trase_tpu field of n live gaussians in `capacity` slots (dead
    slots inside the live range too), SH degree 1, and the port's copy."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32) + shift
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    jp, ja = JG.from_point_cloud(pts, cols, sh_degree=1, capacity=capacity,
                                 dist2=np.full(n, 0.003, np.float32))
    jp = jp._replace(
        rotation=jnp.asarray(rng.normal(size=(capacity, 4)).astype(
            np.float32)),
        opacity=jnp.asarray(rng.normal(1.0, 1.0, size=(capacity, 1)).astype(
            np.float32)),
        features_rest=jnp.asarray((0.2 * rng.normal(
            size=jp.features_rest.shape)).astype(np.float32)))
    alive = np.asarray(ja.alive).copy()
    alive[:3] = False
    ja = ja._replace(alive=jnp.asarray(alive))
    tp, ta = TG.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  jax.tree_util.tree_map(np.asarray, ja),
                                  device="cpu")
    return jp, ja, tp, ta


@pytest.mark.parametrize("case", ["edited", "identity_masked"])
def test_render_composite_matches_trase_tpu(case):
    """A ragged background (150 gaussians in 181 slots) plus a 77-gaussian
    object set in 77 slots (a composite capacity of 258), the object's
    deformation deltas injected."""
    H = W = 64
    jb, jba, tb, tba = field(150, 181, 0, np.array([0, 0, 4.0], np.float32))
    jo, joa, to, toa = field(77, 77, 1, np.array([0.3, 0.1, 3.5], np.float32))
    rng = np.random.default_rng(2)
    d = [(0.05 * rng.normal(size=(77, k))).astype(np.float32)
         for k in (3, 4, 3)]
    mask = rng.uniform(size=77) > 0.2
    if case == "edited":
        edit = dict(scales_bias=1.4, motion_bias=(0.3, -0.2, 0.4),
                    rotation_bias=(0.4, -0.9, 1.3))
        jmask = tmask = None
    else:
        edit = {}
        jmask, tmask = jnp.asarray(mask), torch.tensor(mask)
    R, T = np.eye(3), np.array([0.05, -0.1, 0.0])
    jc = j_camera(R, T, 0.9, 0.9, H, W)
    tc = t_camera(R, T, 0.9, 0.9, H, W, device="cpu")
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jcfg = JRasterConfig(pairs_per_gaussian=16)

    @jax.jit
    def ref_fn(buffers, bp, ba, op, oa, dx, dr, ds, bgc, m):
        return j_render_composite(
            JRenderCamera(buffers, H, W), bp, ba, op, oa, dx, dr, ds, bgc,
            sh_degree=1, mask=m, raster_cfg=jcfg,
            backend="pallas_interpret", **edit)

    ref = ref_fn(jc.buffers, jb, jba.alive, jo, joa.alive,
                 *map(jnp.asarray, d), jnp.asarray(bg), jmask)["render"]
    with torch.no_grad():
        got = t_render_composite(
            tc, tb, tba.alive, to, toa.alive, *map(torch.tensor, d),
            torch.tensor(bg),
            sh_degree=1, mask=tmask,
            raster_cfg=TRasterConfig(pairs_per_gaussian=16), **edit)["render"]
    assert got.shape == (3, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=RENDER_TOL, rtol=0)
    assert float(got.max()) > 0.3  # both sets are in view
