"""Port parity for the math core: covariance, projection, SH, rigid
maps, the deform networks (weights carried over with load_flax_params)
and the gaussian containers — trase_tpu_torch against trase_tpu on the
CPU, same numpy inputs."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.models import deform as JD
from trase_tpu.models import gaussians as JG
from trase_tpu.ops import projection as JP
from trase_tpu.utils import rigid as JR
from trase_tpu.utils import sh as JSH

from trase_tpu_torch.models import deform as TD
from trase_tpu_torch.models import gaussians as TG
from trase_tpu_torch.ops import projection as TP
from trase_tpu_torch.utils import rigid as TRG
from trase_tpu_torch.utils import sh as TSH

from test_rasterize import make_camera

torch.set_num_threads(2)


def t(x):
    return torch.from_numpy(np.array(x))


def torch_camera(jcam):
    return TP.CameraBuffers(*[t(x) for x in jcam])


def random_gaussians(n, seed, sh_degree=3):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    scales = rng.uniform(0.02, 0.4, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.0, 1.0, size=n).astype(np.float32)
    opac[:5] = 0.0  # culled by opacity
    means[5:8, 2] = -6.0  # behind the camera
    sh = (0.3 * rng.normal(size=(n, (sh_degree + 1) ** 2, 3))).astype(
        np.float32)
    return means, scales, quats, opac, sh


def test_compute_cov3d():
    means, scales, quats, _, _ = random_gaussians(200, 0)
    ref = JP.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats), 1.3)
    got = TP.compute_cov3d(t(scales), t(quats), 1.3)
    # same scalar formulas in the same order: float32 rounding only
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_project_gaussians(sh_degree):
    H, W = 48, 64
    jcam = make_camera(H, W)
    means, scales, quats, opac, sh = random_gaussians(300, sh_degree + 1)
    cov = JP.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats))
    ref = JP.project_gaussians(jnp.asarray(means), cov, jnp.asarray(opac),
                               jcam, H, W, sh_coeffs=jnp.asarray(sh),
                               sh_degree=sh_degree)
    got = TP.project_gaussians(t(means), t(np.asarray(cov)), t(opac),
                               torch_camera(jcam), H, W, sh_coeffs=t(sh),
                               sh_degree=sh_degree)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert 0 < int(got.valid.sum()) < 300
    v = got.valid.numpy()
    # float32 reassociation only (XLA may fuse / reorder); the screen
    # quantities are pixels (tens) and the conic spans decades, so
    # relative tolerances
    for name, rtol, atol in (("mean2d", 1e-5, 1e-4), ("depth", 1e-6, 1e-6),
                             ("conic", 1e-4, 1e-6), ("color", 1e-5, 1e-6),
                             ("opacity", 0, 0), ("extent", 1e-5, 1e-4)):
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(ref, name))
        if name in ("mean2d", "conic", "extent"):
            a, b = a[v], b[v]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)
    # radius = ceil(3 sqrt(lambda)): identical unless an ulp lands on an
    # integer boundary
    rad_diff = np.abs(got.radius.numpy() - np.asarray(ref.radius))
    assert rad_diff.max() <= 1.0 and (rad_diff > 0).sum() <= 1


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(50, 3, (deg + 1) ** 2)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = JSH.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d))
    got = TSH.eval_sh(deg, t(sh), t(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_exp_se3():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(20, 6)).astype(np.float32)
    th = rng.uniform(0.1, 2.0, size=(20, 1)).astype(np.float32)
    ref = JR.exp_se3(jnp.asarray(s), jnp.asarray(th))
    got = TRG.exp_se3(t(s), t(th))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_frequency_embed_block_order():
    x = np.random.default_rng(1).normal(size=(7, 3)).astype(np.float32)
    ref = JD.frequency_embed(jnp.asarray(x), 4)
    got = TD.frequency_embed(t(x), 4)
    assert got.shape == (7, 27)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("model_type,is_blender,is_6dof", [
    ("DeformNetwork", False, False),
    ("DeformNetwork", True, False),
    ("DeformNetwork", False, True),
    ("DeformSemanticNetwork", False, False),
])
def test_deform_variants(model_type, is_blender, is_6dof):
    """Every variant, flax weights carried over with load_flax_params."""
    jnet = JD.make_deform_network(model_type, is_blender=is_blender,
                                  is_6dof=is_6dof)
    variables = JD.init_deform(jax.random.PRNGKey(3), jnet)
    v_np = jax.tree_util.tree_map(np.asarray, variables)
    tnet = TD.load_flax_params(
        TD.make_deform_network(model_type, is_blender=is_blender,
                               is_6dof=is_6dof, device="cpu"), v_np)
    rng = np.random.default_rng(4)
    n = 64
    xyz = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    tt = np.full((n, 1), 0.37, np.float32)
    feats = rng.normal(size=(n, 32)).astype(np.float32) \
        if model_type == "DeformSemanticNetwork" else None
    ref = JD.deform_step(jnet, variables, jnp.asarray(xyz), jnp.asarray(tt),
                         None if feats is None else jnp.asarray(feats))
    with torch.no_grad():
        got = TD.deform_step(tnet, t(xyz), t(tt),
                             None if feats is None else t(feats))
    # f32 matmul chains of depth 10: summation order differs between
    # XLA's and torch's CPU GEMMs
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


def test_load_flax_params_rejects_other_network():
    jnet = JD.make_deform_network("DeformNetwork", is_blender=True)
    v_np = jax.tree_util.tree_map(
        np.asarray, JD.init_deform(jax.random.PRNGKey(0), jnet))
    with pytest.raises(ValueError):
        TD.load_flax_params(TD.make_deform_network(device="cpu"), v_np)


@pytest.mark.parametrize("with_dist2", [True, False])
def test_from_point_cloud(with_dist2):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(120, 3)).astype(np.float32)
    cols = rng.uniform(size=(120, 3)).astype(np.float32)
    d2 = np.full(120, 0.0004, np.float32) if with_dist2 else None
    jp, ja = JG.from_point_cloud(pts, cols, sh_degree=2, dist2=d2)
    tp, ta = TG.from_point_cloud(pts, cols, sh_degree=2, dist2=d2,
                                 device="cpu")
    for name in TG.GaussianParams._fields:
        a, b = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        assert a.shape == b.shape, name
        # the 3-NN distances come from two GEMM-based distance matrices
        tol = 0 if with_dist2 or name != "scaling" else 1e-5
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_array_equal(ta.alive.numpy(), np.asarray(ja.alive))


def test_params_from_numpy_roundtrip():
    rng = np.random.default_rng(2)
    jp, ja = JG.from_point_cloud(rng.normal(size=(10, 3)),
                                 rng.uniform(size=(10, 3)), sh_degree=1,
                                 dist2=np.full(10, 0.01))
    p_np = jax.tree_util.tree_map(np.asarray, jp)
    a_np = jax.tree_util.tree_map(np.asarray, ja)
    tp, ta = TG.params_from_numpy(p_np, a_np, device="cpu")
    for name in TG.GaussianParams._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      getattr(p_np, name))
    assert ta.alive.dtype == torch.bool
    np.testing.assert_array_equal(ta.alive.numpy(), a_np.alive)
    # activations agree
    np.testing.assert_allclose(TG.get_opacity(tp).numpy(),
                               np.asarray(JG.get_opacity(jp)), rtol=1e-6)
    np.testing.assert_allclose(TG.get_rotation(tp).numpy(),
                               np.asarray(JG.get_rotation(jp)), rtol=1e-6)
