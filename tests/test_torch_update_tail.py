"""The training steps' update tail (engine/trainer.py: _update) and its
hand-written CUDA version (csrc/update_tail.cu, ops/update_tail.py).

On the CPU: the fused tail's segment tables as each step's signature
builds them (what it writes, what it only checks, row masks, rates, block
layout; every deform net the port builds fits one table, more is refused),
and the tail's guard on the plain path
(a non-finite loss, gradient, densify input or unwritten checked tensor
skips the step; unwritten leaves come back as the input's own tensors; a
row mask freezes param and moments). On the card (skipped without one):
the fused tail against _update_plain bit for bit, every leaf and the flag,
at the GAUSSIAN step's signature at capacity 131072 with the deform net's
22 tensors, FEATURE's, the style step's, the largest deform net's (a
parameter block over 4 KB), odd lengths and unaligned views,
an all-false row mask, a NaN in each kind of segment, three chained steps,
and the bias corrections over many step counts. Imports no jax, so the card
cases run on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_update_tail.py
"""
import numpy as np
import pytest
import torch

from trase_tpu_torch.engine import trainer as T
from trase_tpu_torch.engine.optim import AdamState, adam_update
from trase_tpu_torch.models import gaussians as G
from trase_tpu_torch.models.deform import make_deform_network
from trase_tpu_torch.ops import cuda_lib as CL
from trase_tpu_torch.ops import update_tail as UT

# the deform net's tensors in flax order (DeformNetwork 8x256, t_multires 10)
DEFORM_SHAPES = ([(256, 84), (256,)] + [(256, 256), (256,)] * 4
                 + [(256, 340), (256,)] + [(256, 256), (256,)] * 2
                 + [(3, 256), (3,), (4, 256), (4,), (3, 256), (3,)])
LRS = T.LearningRates(xyz=1.6e-4 * 5 * 0.37, features_dc=2.5e-3,
                      features_rest=2.5e-3 / 20, opacity=0.05,
                      scaling=5e-3, rotation=1e-3, gaussian_features=2.5e-3,
                      deform=3.3e-4)
HEIGHT, WIDTH = 536, 960
# name -> (fields trained, deform trained, densify statistics, guard_deform,
# row mask): the three steps' calls of _update (GAUSSIAN before the deform
# net is on; FEATURE after densification, values-only)
SIGNATURES = {
    "gaussian": (T.TRAINED, True, True, True, "alive"),
    "gaussian_before_deform": (T.TRAINED, False, True, True, "alive"),
    "feature": (("gaussian_features",), False, True, False, "alive"),
    "feature_values_only": (("gaussian_features",), False, False, False,
                            "alive"),
    "style": (("features_dc", "features_rest"), False, True, False,
              "alive_style"),
}


def make_state(capacity: int, seed: int = 0, step: int = 9000,
               deform_shapes=DEFORM_SHAPES) -> T.TrainState:
    """A seeded state on the CPU: normal params, a quarter of the rows
    dead, moments of a trained state, a step count per tensor."""
    gen = torch.Generator().manual_seed(seed)
    C = capacity

    def rnd(*shape):
        return torch.randn(shape, generator=gen)

    params = G.GaussianParams(
        xyz=rnd(C, 3), features_dc=rnd(C, 1, 3), features_rest=rnd(C, 15, 3),
        scaling=rnd(C, 3), rotation=rnd(C, 4), opacity=rnd(C, 1),
        gaussian_features=rnd(C, 32), cluster_id=rnd(C, 1))
    aux = G.GaussianAux(
        alive=torch.rand(C, generator=gen) < 0.75,
        max_radii2d=torch.ceil(20 * torch.rand(C, generator=gen)),
        xyz_gradient_accum=torch.rand(C, generator=gen),
        denom=torch.floor(50 * torch.rand(C, generator=gen)))
    counter = iter(range(step, step + 1000))

    def adam(shape):
        return AdamState(mu=1e-3 * rnd(*shape),
                         nu=1e-6 * rnd(*shape).square(),
                         step=torch.tensor(next(counter), dtype=torch.int32))

    opt = G.GaussianOptState(**{k: adam(getattr(params, k).shape)
                                for k in G.GaussianOptState._fields})
    deform = [0.05 * rnd(*s) for s in deform_shapes]
    return T.TrainState(params, aux, opt, deform,
                        [adam(s) for s in deform_shapes])


def signature(name: str, state: T.TrainState, seed: int = 1) -> dict:
    """_update's arguments for one step's signature on `state`."""
    fields, deform, densify, guard_deform, mask = SIGNATURES[name]
    gen = torch.Generator().manual_seed(seed)
    dev = state.params.xyz.device
    C = state.params.xyz.shape[0]

    def rnd(shape, scale):
        return (scale * torch.randn(tuple(shape), generator=gen)).to(dev)

    row_mask = state.aux.alive
    if mask == "alive_style":
        row_mask = row_mask & (torch.rand(C, generator=gen) < 0.3).to(dev)
    kw = dict(lrs=LRS, row_mask=row_mask,
              grads={k: rnd(getattr(state.params, k).shape, 1e-3)
                     for k in fields},
              loss=rnd((), 1.0).abs(), guard_deform=guard_deform)
    if deform:
        kw["deform_grads"] = [rnd(t.shape, 1e-2) for t in state.deform]
    if densify:
        kw["densify"] = (rnd((C, 2), 1e-3),
                         (torch.rand(C, generator=gen) < 0.6).to(dev),
                         torch.ceil(30 * torch.rand(C, generator=gen)).to(dev),
                         HEIGHT, WIDTH)
    return kw


def to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: to(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(to(v, dev) for v in x)
    if hasattr(x, "_fields"):
        return type(x)(*(to(v, dev) for v in x))
    return x


def leaves(state: T.TrainState) -> list:
    """(name, tensor) for every leaf of the state."""
    out = [(f"params.{k}", v) for k, v in state.params._asdict().items()]
    out += [(f"aux.{k}", v) for k, v in state.aux._asdict().items()]
    for k, s in state.opt._asdict().items():
        out += [(f"opt.{k}.{f}", v) for f, v in s._asdict().items()]
    out += [(f"deform.{i}", v) for i, v in enumerate(state.deform)]
    for i, s in enumerate(state.deform_opt):
        out += [(f"deform_opt.{i}.{f}", v) for f, v in s._asdict().items()]
    return out


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_same_bits(a, fa, b, fb):
    """Two (state, finite) results leaf for leaf, bit for bit."""
    assert fa.dtype == fb.dtype == torch.bool and fa.shape == ()
    assert bool(fa) == bool(fb)
    for (name, x), (_, y) in zip(leaves(a), leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        assert torch.equal(bits(x), bits(y)), name


def expected_checks(name: str, state: T.TrainState, loss) -> list:
    """What the guard checks and the step does not write, by the
    signature's table above."""
    fields, deform, densify, guard_deform, _ = SIGNATURES[name]
    p, aux, opt = state.params, state.aux, state.opt
    out = [getattr(p, k) for k in p._fields if k not in fields]
    if not densify:
        out += [aux.max_radii2d, aux.xyz_gradient_accum, aux.denom]
    out += [t for k in opt._fields if k not in fields
            for t in (getattr(opt, k).mu, getattr(opt, k).nu)]
    if guard_deform and not deform:
        out += list(state.deform)
        out += [t for s in state.deform_opt for t in (s.mu, s.nu)]
    return out + [loss]


# ------------------------------------------------------------ the CPU


@pytest.mark.parametrize("name", list(SIGNATURES))
def test_segment_tables_by_signature(name):
    """The table a signature builds: its Adam segments are the fields
    (rows masked, at their rates) then the deform tensors (unmasked, at
    the deform rate); densify where the step accumulates; the check
    segments are exactly the guarded tensors it does not write, and the
    loss; blocks in proportion to each segment's length."""
    fields, deform, densify, _, _ = SIGNATURES[name]
    state = make_state(64)
    kw = signature(name, state)
    adam, stats, checks = T.tail_segments(
        state, kw["lrs"], kw["grads"], kw["row_mask"], kw["loss"],
        deform_grads=kw.get("deform_grads"), densify=kw.get("densify"),
        guard_deform=kw["guard_deform"])
    want = [(getattr(state.params, k), getattr(state.opt, k),
             getattr(LRS, k), True) for k in fields]
    if deform:
        want += [(t, s, LRS.deform, False)
                 for t, s in zip(state.deform, state.deform_opt)]
    assert len(adam) == len(want)
    for a, (param, st, lr, masked) in zip(adam, want):
        assert a.param is param
        assert (a.mu, a.nu, a.step) == tuple(st)
        assert (a.lr, a.masked) == (lr, masked)
    assert (stats is not None) == densify
    if densify:
        assert stats.accum is state.aux.xyz_gradient_accum
        assert stats.alive is state.aux.alive
    exp = expected_checks(name, state, kw["loss"])
    assert len(checks) == len(exp)
    assert all(a is b for a, b in zip(checks[:-1], exp[:-1]))
    assert torch.equal(checks[-1], kw["loss"])

    tail = UT.tail_table(adam, stats, checks, kw["row_mask"])
    tab = tail.table
    assert tab.n_adam == len(adam) and tab.n_check == len(checks)
    assert UT.segments(tab) == len(adam) + len(checks) + densify
    assert tab.row_mask == kw["row_mask"].data_ptr()
    assert tab.flag == tail.finite.data_ptr()
    assert tab.one_minus_b1 == np.float32(1 - 0.9)
    blocks = 0
    for j, (a, (p_out, *s_out)) in enumerate(zip(adam, tail.adam)):
        seg = tab.adam[j]
        assert (seg.p, seg.g, seg.m, seg.v, seg.step) == tuple(
            x.data_ptr() for x in (a.param, a.grad, a.mu, a.nu, a.step))
        assert (seg.p_out, seg.m_out, seg.v_out, seg.step_out) == tuple(
            x.data_ptr() for x in (p_out, *s_out))
        assert p_out.shape == a.param.shape and p_out is not a.param
        assert seg.n == a.param.numel()
        assert seg.row_width == (a.param.numel() // 64 if a.masked else 0)
        assert seg.lr == np.float32(a.lr)
        assert seg.block_begin == blocks
        blocks += max(1, -(-a.param.numel() // UT.CHUNK))
    assert tab.adam_end == blocks
    if densify:
        d = tab.densify
        assert (d.n, d.half_w, d.half_h, d.block_begin) == (
            64, WIDTH / 2, HEIGHT / 2, blocks)
        assert d.max_radii_out == tail.densify[2].data_ptr()
        blocks += 1
    assert tab.densify_end == blocks
    for j, x in enumerate(checks):
        assert (tab.check[j].x, tab.check[j].n,
                tab.check[j].block_begin) == (x.data_ptr(), x.numel(), blocks)
        blocks += -(-x.numel() // UT.CHUNK)
    assert tab.n_blocks == blocks


def net_shapes(is_blender: bool, is_6dof: bool) -> list:
    """A deform net's tensor shapes in flax order."""
    net = make_deform_network(is_blender=is_blender, is_6dof=is_6dof,
                              device="cpu")
    return [tuple(t.shape) for layer in net.flax_order()
            for t in (layer.weight, layer.bias)]


@pytest.mark.parametrize("is_blender", [False, True])
@pytest.mark.parametrize("is_6dof", [False, True])
def test_every_deform_net_fits_one_table(is_blender, is_6dof):
    """Each step's signature with each deform net the port builds fits
    the one table; the largest net (Blender's time net and the 6-DoF
    heads) makes 34 Adam segments, and 89 checks before the deform net is
    on. One segment past MAX_ADAM or MAX_CHECK is refused."""
    state = make_state(64, deform_shapes=net_shapes(is_blender, is_6dof))
    most = [0, 0]
    for name in SIGNATURES:
        kw = signature(name, state)
        adam, stats, checks = T.tail_segments(
            state, kw["lrs"], kw["grads"], kw["row_mask"], kw["loss"],
            deform_grads=kw.get("deform_grads"), densify=kw.get("densify"),
            guard_deform=kw["guard_deform"])
        tab = UT.tail_table(adam, stats, checks, kw["row_mask"]).table
        assert (tab.n_adam, tab.n_check) == (len(adam), len(checks)), name
        most = [max(most[0], len(adam)), max(most[1], len(checks))]
        over = adam * (UT.MAX_ADAM // len(adam) + 1)
        with pytest.raises(ValueError):
            UT.tail_table(over[:UT.MAX_ADAM + 1], stats, checks,
                          kw["row_mask"])
        over = checks * (UT.MAX_CHECK // len(checks) + 1)
        with pytest.raises(ValueError):
            UT.tail_table(adam, stats, over[:UT.MAX_CHECK + 1],
                          kw["row_mask"])
    if is_blender and is_6dof:
        assert most == [34, 89]


def test_segment_tables_refuse_what_the_kernel_does_not_take():
    state = make_state(64)
    kw = signature("feature", state)
    adam, stats, checks = T.tail_segments(
        state, kw["lrs"], kw["grads"], kw["row_mask"], kw["loss"],
        densify=kw["densify"])
    for bad in (checks[:-1] + [checks[-1].double()],
                checks[:-1] + [state.params.xyz.t()]):
        with pytest.raises(ValueError):
            UT.tail_table(adam, stats, bad, kw["row_mask"])
    with pytest.raises(ValueError):
        UT.tail_table(adam, stats, checks, None)
    with pytest.raises(ValueError):
        UT.update_tail(adam, stats, checks, kw["row_mask"])  # CPU tensors


def inject(kind: str, state: T.TrainState, kw: dict):
    """A NaN in one kind of segment: a live row's gradient (Adam), a
    visible alive row's screen gradient (densify), an unwritten guarded
    tensor (check) or the loss."""
    live = int(torch.nonzero(kw["row_mask"])[0])
    if kind == "adam":
        kw["grads"]["features_dc"][live, 0, 1] = float("nan")
    elif kind == "densify":
        seen = kw["densify"][1] & state.aux.alive
        kw["densify"][0][int(torch.nonzero(seen)[0]), 1] = float("nan")
    elif kind == "check":
        state.params.cluster_id[3, 0] = float("inf")
    else:
        kw["loss"] = torch.full_like(kw["loss"], float("nan"))
    return kw


@pytest.mark.parametrize("kind", ["adam", "densify", "check", "loss"])
def test_nonfinite_skips_the_step(kind):
    """A non-finite gradient, densify input, guarded tensor or loss: the
    flag is false and every leaf comes back as it was."""
    state = make_state(64)
    old = [x.clone() for _, x in leaves(state)]
    kw = inject(kind, state, signature("style", state))
    new, finite = T._update(state, **kw)
    assert finite.shape == () and not bool(finite)
    for (name, x), y in zip(leaves(new), old):
        if name != "params.cluster_id":
            assert torch.equal(x, y), name


@pytest.mark.parametrize("name", list(SIGNATURES))
def test_unwritten_leaves_are_the_inputs(name):
    """_update returns the input's own tensor for every leaf the step
    does not write, a new one for each it writes; the CPU takes the plain
    path and counts it."""
    fields, deform, densify, _, _ = SIGNATURES[name]
    state = make_state(64)
    before = dict(T.UPDATE_TAIL)
    new, finite = T._update(state, **signature(name, state))
    assert bool(finite)
    assert T.UPDATE_TAIL[("plain",)] == before.get(("plain",), 0) + 1
    written = {f"params.{k}" for k in fields}
    written |= {f"opt.{k}.{f}" for k in fields for f in AdamState._fields}
    if densify:
        written |= {"aux.xyz_gradient_accum", "aux.denom", "aux.max_radii2d"}
    if deform:
        written |= {n for n, _ in leaves(state) if n.startswith("deform")}
    for (n, x), (_, y) in zip(leaves(new), leaves(state)):
        assert (x is not y) == (n in written), n


def test_row_mask_freezes_param_and_moments():
    """Rows outside the row mask keep param, mu and nu; the rows inside
    move; the step count rises by one for the whole tensor."""
    state = make_state(64)
    kw = signature("style", state)
    new, _ = T._update(state, **kw)
    m = kw["row_mask"]
    assert 0 < int(m.sum()) < 64
    for k in ("features_dc", "features_rest"):
        for a, b in ((getattr(new.params, k), getattr(state.params, k)),
                     (getattr(new.opt, k).mu, getattr(state.opt, k).mu),
                     (getattr(new.opt, k).nu, getattr(state.opt, k).nu)):
            assert torch.equal(a[~m], b[~m])
            assert not torch.equal(a[m], b[m])
        assert int(getattr(new.opt, k).step) == int(
            getattr(state.opt, k).step) + 1


# ------------------------------------------------------------ the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def both(state, kw):
    """(fused, plain) results of the same call on the card, and the
    fused call's launches."""
    keys = dict(CL.LAYOUT_LAUNCHES)
    fused = T._update(state, **kw)
    launched = {k: v - keys.get(k, 0) for k, v in CL.LAYOUT_LAUNCHES.items()
                if v != keys.get(k, 0)}
    plain = T._update_plain(state, **kw)
    torch.cuda.synchronize()
    return fused, plain, launched


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SIGNATURES) + ["gaussian_largest_net",
                                                     "before_largest_net"])
def test_card_tail_equals_plain(card, name):
    """Each step's signature on the card (GAUSSIAN at capacity 131072
    with the deform net's 22 tensors; GAUSSIAN after and before the deform
    net is on with the largest net, a full table): every leaf and the flag
    bit for bit the plain tail's, one tail launch and one commit, the call
    counted as fused, unwritten leaves the input's own."""
    capacity = 131072 if name == "gaussian" else 4096
    shapes = DEFORM_SHAPES
    if name.endswith("largest_net"):
        shapes = net_shapes(True, True)
        name = "gaussian" if name.startswith("gaussian") else (
            "gaussian_before_deform")
    state = to(make_state(capacity, deform_shapes=shapes), card)
    kw = to(signature(name, state), card)
    before = T.UPDATE_TAIL.get(("fused",), 0)
    (new, finite), (ref, ref_finite), launched = both(state, kw)
    assert bool(finite)
    assert_same_bits(new, finite, ref, ref_finite)
    adam, stats, checks = T.tail_segments(
        state, kw["lrs"], kw["grads"], kw["row_mask"], kw["loss"],
        deform_grads=kw.get("deform_grads"), densify=kw.get("densify"),
        guard_deform=kw["guard_deform"])
    segments = len(adam) + (stats is not None) + len(checks)
    assert launched == {("update_tail", segments): 1, ("update_commit",): 1}
    assert T.UPDATE_TAIL[("fused",)] == before + 1
    for (n, x), (_, y), (_, z) in zip(leaves(new), leaves(ref),
                                      leaves(state)):
        assert (x is z) == (y is z), n


@pytest.mark.cuda
def test_card_odd_lengths_and_unaligned_views(card):
    """Rows and deform tensors whose lengths are no multiple of 4 (the
    vector width) or of a block's 2048, and params that are views one
    float into their storage (not 16-byte aligned): the scalar path."""
    shapes = [(3, 7), (7,), (257,), (5, 1001)]
    state = to(make_state(1001, deform_shapes=shapes), card)
    buf = torch.empty(1001 * 3 + 1, device=card)
    xyz = buf[1:].view(1001, 3)
    xyz.copy_(state.params.xyz)
    state = state._replace(params=state.params._replace(xyz=xyz))
    kw = to(signature("gaussian", state), card)
    (new, finite), (ref, ref_finite), _ = both(state, kw)
    assert bool(finite)
    assert_same_bits(new, finite, ref, ref_finite)


@pytest.mark.cuda
def test_card_all_false_row_mask(card):
    state = to(make_state(4096), card)
    kw = to(signature("gaussian", state), card)
    kw["row_mask"] = torch.zeros_like(kw["row_mask"])
    (new, finite), (ref, ref_finite), _ = both(state, kw)
    assert_same_bits(new, finite, ref, ref_finite)
    assert torch.equal(new.params.xyz, state.params.xyz)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["adam", "densify", "check", "loss"])
def test_card_nonfinite_in_each_segment_kind(card, kind):
    """A NaN in an Adam, densify or check segment or in the loss: the
    flag false and every written leaf back to the input, as the plain
    tail's where."""
    state = to(make_state(4096), card)
    kw = inject(kind, state, to(signature("gaussian", state), card))
    (new, finite), (ref, ref_finite), _ = both(state, kw)
    assert not bool(finite)
    assert_same_bits(new, finite, ref, ref_finite)
    assert_same_bits(new, finite, state, ref_finite)


@pytest.mark.cuda
def test_card_three_chained_steps(card):
    """Three GAUSSIAN tails chained through their own states, fused and
    plain apart, bit for bit at each; the step counts read back."""
    a = b = to(make_state(8192), card)
    for i in range(3):
        kw = to(signature("gaussian", a, seed=10 + i), card)
        a, fa = T._update(a, **kw)
        b, fb = T._update_plain(b, **kw)
        assert_same_bits(a, fa, b, fb)
    steps = [int(s.step) for s in a.opt] + [int(s.step)
                                           for s in a.deform_opt]
    assert steps[:len(T.TRAINED)] == [9003 + i for i in range(6)]
    assert steps[-1] == 9000 + 7 + len(DEFORM_SHAPES) - 1 + 3


@pytest.mark.cuda
def test_card_bias_corrections_over_step_counts(card):
    """powf(b, t) and the corrections against torch.pow's over the step
    counts a schedule reaches: one-element tensors, MAX_ADAM a launch,
    each against adam_update."""
    counts = (list(range(0, 1100)) + list(range(8990, 9100))
              + list(range(19990, 20100)) + list(range(29990, 30100)))
    gen = torch.Generator().manual_seed(5)
    for lo in range(0, len(counts), UT.MAX_ADAM):
        segs, want = [], []
        for t in counts[lo:lo + UT.MAX_ADAM]:
            p, g, m = (torch.randn(1, generator=gen).to(card) for _ in "pgm")
            st = AdamState(1e-3 * m, 1e-6 * m.square(),
                           torch.tensor(t, dtype=torch.int32, device=card))
            segs.append(UT.AdamSegment(p, 1e-3 * g, *st, 1e-3, False))
            want.append(adam_update(p, 1e-3 * g, st, 1e-3))
        tail = UT.update_tail(segs, None, [], None)
        UT.update_commit(tail, tail.finite)
        for (p, mu, nu, step), (wp, ws) in zip(tail.adam, want):
            assert torch.equal(bits(p), bits(wp))
            assert torch.equal(bits(mu), bits(ws.mu))
            assert torch.equal(bits(nu), bits(ws.nu))
            assert torch.equal(step, ws.step)
