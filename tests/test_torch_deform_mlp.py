"""Port parity for the fused deform MLP: the plain PyTorch version of
csrc/deform_mlp.cu (ops/mlp_cuda.py: fused_deform_mlp_plain) against
trase_tpu's Pallas kernel (ops/mlp_pallas.py, interpret mode on the CPU,
as tests/test_rasterize_pallas.py::test_fused_deform_matches_flax runs
it) on one flax init carried into the port's network; the fused path
against the float32 module; the architecture gate; the weight packing
against trase_tpu's split of the same flax tree; the kernel's device
layout of it, undone element by element; and the cache of that layout on
the network."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trase_tpu.models import deform as JD
from trase_tpu.ops import mlp_pallas as JM

from trase_tpu_torch.models import deform as TD
from trase_tpu_torch.ops import mlp_cuda as TM

torch.set_num_threads(2)

# kernel arithmetic (bf16 operands, float32 sums in another order):
# activations near a bf16 rounding boundary round the other way, so the
# two differ by a few 1e-3 of each head's scale (2.8e-3 to 5.5e-3
# measured at these sizes); 1e-2 of scale is the budget
PALLAS_TOL = 1e-2
# fused (bf16 stack) against the float32 module:
# test_fused_deform_matches_flax's budget
MODULE_TOL = 2e-2


def _nets(model_type="DeformNetwork", **kw):
    jnet = JD.make_deform_network(model_type, **kw)
    variables = JD.init_deform(jax.random.PRNGKey(0), jnet)
    tnet = TD.load_flax_params(
        TD.make_deform_network(model_type, device="cpu", **kw),
        jax.tree_util.tree_map(np.asarray, variables))
    return jnet, variables, tnet


def _inputs(n, seed=0, t=0.42):
    xyz = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return xyz, np.full((n, 1), t, np.float32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-6)


@pytest.mark.parametrize("n", [300, 4100])
def test_plain_matches_pallas_kernel(n):
    """fused_deform_mlp_plain against trase_tpu's deform_step(fused=True)
    (the Pallas kernel in interpret mode) within PALLAS_TOL of each
    head's scale; ragged sizes (300, 4100 = 2 * 2048 + 4 rows)."""
    jnet, variables, tnet = _nets()
    xyz, t = _inputs(n)
    ref = JD.deform_step(jnet, variables, jnp.asarray(xyz), jnp.asarray(t),
                         fused=True)
    got = TD.deform_step(tnet, torch.from_numpy(xyz), torch.from_numpy(t),
                         fused=True)
    for name, a, b in zip(("d_xyz", "d_rot", "d_scale"), ref, got):
        assert b.shape == a.shape and b.dtype == torch.float32, name
        assert _rel(a, b.numpy()) <= PALLAS_TOL, (name, _rel(a, b.numpy()))


def test_fused_matches_module():
    """The port's mirror of test_fused_deform_matches_flax: the fused
    path within MODULE_TOL of the float32 module path."""
    _, _, tnet = _nets()
    xyz, t = _inputs(300)
    x, tt = torch.from_numpy(xyz), torch.from_numpy(t)
    with torch.no_grad():
        ref = TD.deform_step(tnet, x, tt)
    fus = TD.deform_step(tnet, x, tt, fused=True)
    for a, b in zip(ref, fus):
        assert _rel(a.numpy(), b.numpy()) < MODULE_TOL


@pytest.mark.parametrize("variant", [
    dict(model_type="DeformStaticNetwork"),
    dict(model_type="DeformDynamicNetwork"),
    dict(model_type="DeformSemanticNetwork"),
    dict(model_type="DeformNetwork", is_6dof=True),
    dict(model_type="DeformNetwork", is_blender=True)])
def test_gate_routes_as_trase_tpu(variant):
    """fused_available decides as trase_tpu's gate does. Where it says
    no (Semantic, called with features; 6-DoF; blender), fused=True is the
    module path exactly; where it says yes (the Static and Dynamic time
    octaves keep the standard stack), the fused result agrees with
    trase_tpu's Pallas kernel within PALLAS_TOL."""
    jnet, variables, tnet = _nets(**variant)
    assert TM.fused_available(tnet) == JM.fused_available(jnet)
    xyz, t = _inputs(200, seed=3)
    x, tt = torch.from_numpy(xyz), torch.from_numpy(t)
    feats = None
    if tnet.feature_dim:
        feats = torch.from_numpy(np.random.default_rng(4).normal(
            size=(200, 32)).astype(np.float32))
    with torch.no_grad():
        ref = TD.deform_step(tnet, x, tt, feats)
        fus = TD.deform_step(tnet, x, tt, feats, fused=True)
    if not TM.fused_available(tnet):
        for a, b in zip(ref, fus):
            assert torch.equal(a, b)
        return
    jref = JD.deform_step(jnet, variables, jnp.asarray(xyz), jnp.asarray(t),
                          fused=True)
    for a, b in zip(jref, fus):
        assert _rel(a, b.numpy()) <= PALLAS_TOL


def test_pack_matches_pallas_split():
    """pack_fused_weights holds trase_tpu's split of the same flax tree
    (fused_deform_mlp: ws_in = Dense_5[:in_dim], ws_h = Dense_5[in_dim:],
    wh = the three heads side by side), transposed to nn.Linear's
    (out, in), hidden weights rounded to bf16, biases and heads float32,
    and zero columns past in_dim."""
    _, variables, tnet = _nets()
    p = jax.tree_util.tree_map(np.asarray, variables["params"])
    w = TM.pack_fused_weights(tnet)
    d = w.in_dim
    assert d == 84 and w.w0.shape == (256, 96)

    def bf(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)

    w5 = p["Dense_5"]["kernel"]
    assert torch.equal(w.ws_in[:, :d], bf(w5[:d].T))
    assert torch.equal(w.w_hidden[4], bf(w5[d:].T))
    assert torch.equal(w.w0[:, :d], bf(p["Dense_0"]["kernel"].T))
    assert not w.w0[:, d:].any() and not w.ws_in[:, d:].any()
    for slot, i in enumerate((1, 2, 3, 4, None, 6, 7)):
        if i is not None:
            assert torch.equal(w.w_hidden[slot],
                               bf(p[f"Dense_{i}"]["kernel"].T))
    wh = np.concatenate([p[f"Dense_{i}"]["kernel"] for i in (8, 9, 10)], 1)
    bh = np.concatenate([p[f"Dense_{i}"]["bias"] for i in (8, 9, 10)])
    assert w.wh.dtype == w.bias.dtype == torch.float32
    np.testing.assert_array_equal(w.wh.numpy(), wh)
    np.testing.assert_array_equal(w.bh.numpy(), bh)
    np.testing.assert_array_equal(
        w.bias.numpy(), np.stack([p[f"Dense_{i}"]["bias"] for i in range(8)]))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only; the CPU path is the
    plain version, chosen by deform_step from the tensor's device."""
    _, _, tnet = _nets()
    emb = torch.zeros((8, 84))
    with pytest.raises(ValueError, match="CUDA tensors"):
        TM.fused_deform_mlp(tnet, emb)
    with pytest.raises(ValueError, match="standard DeformNetwork"):
        TM.pack_fused_weights(TD.make_deform_network(is_6dof=True,
                                                     device="cpu"))


def _unswizzle(chunk):
    """One (256, 64) device chunk back to (256, 64): element (r, k) of the
    chunk lies in row r's 16-byte group (k // 8) ^ (r % 8), at k % 8."""
    out = np.empty(chunk.shape, np.float32)
    for r in range(chunk.shape[0]):
        for k in range(chunk.shape[1]):
            out[r, k] = chunk[r, ((k // 8) ^ (r % 8)) * 8 + k % 8]
    return out


@pytest.mark.parametrize("model_type,in_dim", [
    ("DeformStaticNetwork", 68), ("DeformNetwork", 84),
    ("DeformDynamicNetwork", 128)])
def test_device_layout_inverts_to_fused_weights(model_type, in_dim):
    """device_layout's 32 swizzled chunks, undone by hand, give back
    pack_fused_weights's tensors exactly: W0 and Ws_in from 2 chunks each
    (zero past in_dim up to the kernel's 128 input columns), W1..W4, Ws_h,
    W6, W7 from 4 each, in the kernel's order; biases and heads as they
    were."""
    _, _, tnet = _nets(model_type)
    w = TM.pack_fused_weights(tnet)
    assert w.in_dim == in_dim
    dw = TM.device_layout(w)
    assert dw.chunks.shape == (TM.N_CHUNKS, 256, 64)
    chunks = [_unswizzle(c) for c in dw.chunks.float().numpy()]

    def take(n):
        return np.concatenate([chunks.pop(0) for _ in range(n)], axis=1)

    mats = [take(2)] + [take(4) for _ in range(4)] + [take(2)] \
        + [take(4) for _ in range(3)]
    assert not chunks
    kin = w.w0.shape[1]
    for m, packed in ((mats[0], w.w0), (mats[5], w.ws_in)):
        np.testing.assert_array_equal(m[:, :kin], packed.float().numpy())
        assert not m[:, in_dim:].any()
    for m, i in zip(mats[1:5] + mats[6:], (0, 1, 2, 3, 4, 5, 6)):
        np.testing.assert_array_equal(m, w.w_hidden[i].float().numpy())
    for name in ("bias", "wh", "bh"):
        assert torch.equal(getattr(dw, name), getattr(w, name))
    assert dw.in_dim == in_dim


def test_fused_weights_cache_follows_the_parameters():
    """fused_weights packs once and returns the same tensors while no
    parameter changes; an in-place update of one weight and
    load_flax_params (copy_ into every parameter) each repack, and the
    repacked chunks equal a fresh device_layout."""
    _, variables, tnet = _nets()
    first = TM.fused_weights(tnet)
    assert TM.fused_weights(tnet) is first

    with torch.no_grad():
        tnet.linear[3].weight.mul_(2.0)
    second = TM.fused_weights(tnet)
    assert second is not first
    assert not torch.equal(second.chunks, first.chunks)
    assert torch.equal(second.chunks, TM.device_layout(
        TM.pack_fused_weights(tnet)).chunks)
    assert TM.fused_weights(tnet) is second

    TD.load_flax_params(tnet, jax.tree_util.tree_map(np.asarray, variables))
    third = TM.fused_weights(tnet)
    assert third is not second
    assert torch.equal(third.chunks, first.chunks)
