"""Port parity for losses/losses_3d.py against trase_tpu's on the same
points and features (numpy seeds), with trase_tpu's subsample
permutations (jax.random.permutation) passed to the port as index arrays.
Tolerances: 1e-5 relative; the rigid-body loss 1e-4 (a batched 3x3 SVD
in each package)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.losses import losses_3d as JL
from trase_tpu.ops.knn import knn as j_knn

from trase_tpu_torch.losses import losses_3d as TL

torch.set_num_threads(2)

TOL, RIGID_TOL = 1e-5, 1e-4


def rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(a), 1e-12)


def cloud(n, seed, f=8, c=6):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    feats = rng.normal(size=(n, f)).astype(np.float32)
    logits = rng.normal(size=(n, c)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return xyz, feats, probs.astype(np.float32)


def perm(key, n, m):
    return np.array(jax.random.permutation(key, n)[:m])


@pytest.mark.parametrize("n", [400, 600], ids=["no_subsample",
                                               "subsample"])
def test_loss_cls_3d(n):
    _, feats, probs = cloud(n, 0)
    key = jax.random.PRNGKey(3)
    kw = dict(k=5, lambda_val=2.0, max_points=500, sample_size=100)
    want = JL.loss_cls_3d(key, jnp.asarray(feats), jnp.asarray(probs), **kw)
    m = min(n, kw["max_points"])
    sub = perm(key, n, m) if n > m else None
    samp = perm(jax.random.fold_in(key, 1), m, kw["sample_size"])
    got = TL.loss_cls_3d(torch.from_numpy(feats), torch.from_numpy(probs),
                         subsample_idx=None if sub is None
                         else torch.from_numpy(sub),
                         sample_idx=torch.from_numpy(samp), **kw)
    assert rel(want, got) < TOL, (float(want), float(got))


def test_loss_reg_3d_feature():
    xyz, feats, _ = cloud(500, 1)
    want = JL.loss_reg_3d_feature(jnp.asarray(feats), jnp.asarray(xyz), 5)
    got = TL.loss_reg_3d_feature(torch.from_numpy(feats),
                                 torch.from_numpy(xyz), 5)
    assert rel(want, got) < TOL, (float(want), float(got))


@pytest.mark.parametrize("n", [300, 600], ids=["no_subsample",
                                               "subsample"])
def test_loss_feature3d(n):
    xyz, feats, _ = cloud(n, 2)
    key = jax.random.PRNGKey(4)
    kw = dict(kp=16, kn=4, max_points=500, lambda_p=1.0, lambda_n=0.5)
    want = JL.loss_feature3d(key, jnp.asarray(feats), jnp.asarray(xyz), **kw)
    sub = perm(key, n, 500) if n > 500 else None
    got = TL.loss_feature3d(torch.from_numpy(feats), torch.from_numpy(xyz),
                            subsample_idx=None if sub is None
                            else torch.from_numpy(sub), **kw)
    assert rel(want, got) < TOL, (float(want), float(got))


def test_rigid_body_motion_loss():
    """xyz2: a rotation and translation of xyz1 plus noise; neighbours
    from trase_tpu's knn of xyz1 (self included)."""
    xyz1, _, _ = cloud(300, 5)
    rng = np.random.default_rng(6)
    q = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    q[:, 0] *= np.sign(np.linalg.det(q))  # a rotation, not a reflection
    xyz2 = (xyz1 @ q.T + 0.3 + 0.02 * rng.normal(size=xyz1.shape)).astype(
        np.float32)
    _, idx = j_knn(jnp.asarray(xyz1), jnp.asarray(xyz1), 8)
    idx = np.array(idx)
    want = JL.rigid_body_motion_loss(jnp.asarray(xyz1), jnp.asarray(xyz2),
                                     jnp.asarray(idx))
    got = TL.rigid_body_motion_loss(torch.from_numpy(xyz1),
                                    torch.from_numpy(xyz2),
                                    torch.from_numpy(idx))
    assert rel(want, got) < RIGID_TOL, (float(want), float(got))
    # a translation costs nothing; a pure rotation does, in both packages
    # (R = V U^T rotates e2 by the motion again instead of undoing it:
    # ROADMAP.md, Queue 3, reference faults)
    moved = TL.rigid_body_motion_loss(torch.from_numpy(xyz1),
                                      torch.from_numpy(xyz1 + 0.3),
                                      torch.from_numpy(idx))
    assert float(moved) < 1e-8
    rigid = xyz1 @ q.T + 0.3
    want = JL.rigid_body_motion_loss(jnp.asarray(xyz1), jnp.asarray(rigid),
                                     jnp.asarray(idx))
    got = TL.rigid_body_motion_loss(torch.from_numpy(xyz1),
                                    torch.from_numpy(rigid),
                                    torch.from_numpy(idx))
    assert rel(want, got) < RIGID_TOL and float(got) > 1e-3


def test_generator_draws():
    """Without index arrays the subsamples come from the generator: the
    same seed gives the same value, finite."""
    xyz, feats, probs = cloud(700, 7)
    vals = []
    for _ in range(2):
        g = torch.Generator().manual_seed(0)
        vals.append((
            float(TL.loss_cls_3d(torch.from_numpy(feats),
                                 torch.from_numpy(probs), max_points=600,
                                 sample_size=50, generator=g)),
            float(TL.loss_feature3d(torch.from_numpy(feats),
                                    torch.from_numpy(xyz), max_points=500,
                                    generator=g))))
    assert vals[0] == vals[1] and np.isfinite(vals[0]).all()
