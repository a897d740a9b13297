"""Port parity for the render CLI's visualization helpers
(trase_tpu_torch/viz.py) against trase_tpu/viz.py on the same numpy-seeded
inputs: the point splat pixel for pixel, the PCA of a rendered feature map
up to the sign of each component, the jet colormap exactly, and the mp4
writer's output file."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from trase_tpu import viz as JV
from trase_tpu_torch import viz as TV

torch.set_num_threads(2)


@pytest.mark.parametrize("white,colored", [(False, False), (True, True)])
def test_point_splat_matches(white, colored):
    """Same projection, same integer pixel, same last-write order."""
    from trase_tpu.renderer import make_render_camera

    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(500, 3)) * 0.8).astype(np.float32)
    pts[:, 2] += 3.0
    fp = np.asarray(make_render_camera(np.eye(3), np.zeros(3), 0.9, 0.8, 40,
                                       56).buffers.full_proj)
    cols = rng.uniform(size=(500, 3)).astype(np.float32) if colored else None
    ref = JV.point_splat(jnp.asarray(pts), jnp.asarray(fp), 40, 56, cols,
                         white)
    got = TV.point_splat(torch.from_numpy(pts), torch.from_numpy(fp), 40, 56,
                         None if cols is None else torch.from_numpy(cols),
                         white)
    assert got.shape == (3, 40, 56) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert (got != (1.0 if white else 0.0)).any()


def test_feature_to_rgb_up_to_sign():
    rng = np.random.default_rng(1)
    f = (rng.normal(size=(16, 12, 10)) * np.linspace(2, 0.1, 16)[:, None,
                                                                  None])
    f = f.astype(np.float32)
    a = np.asarray(JV.feature_to_rgb(jnp.asarray(f)))
    b = TV.feature_to_rgb(torch.from_numpy(f)).numpy()
    assert a.shape == b.shape == (3, 12, 10)
    for c in range(3):
        r = np.corrcoef(a[c].ravel(), b[c].ravel())[0, 1]
        assert abs(abs(r) - 1.0) < 1e-4, (c, r)


def test_jet_colors_and_video(tmp_path):
    np.testing.assert_array_equal(TV.jet_colors(7), JV.jet_colors(7))
    frames = [np.full((16, 16, 3), 40 * i, np.uint8) for i in range(4)]
    path = str(tmp_path / "v.mp4")
    TV.write_video(path, frames)
    assert os.path.getsize(path) > 0
