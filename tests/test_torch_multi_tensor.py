"""Port parity: the multi-tensor ops of the training step
(``apex_tpu_torch.ops.multi_tensor`` and the ``ops.kernels`` facade).

The plain versions — what a CPU tensor runs, and what the CUDA kernels
are held against on the card — against the JAX package's Pallas kernels
in interpret mode (``P.scale``, ``P.lamb_step``, as
tests/test_pallas_kernels.py runs them) and its jnp reference (``R``), on
the same numpy inputs. Tolerances are test_pallas_kernels.py:30-32's:
rtol 2e-5 / atol 2e-6 in f32, 2e-2 in bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import flat as JF
from apex_tpu.ops import reference as R
from apex_tpu.ops.pallas import multi_tensor as P
from apex_tpu_torch.ops import flat as F
from apex_tpu_torch.ops import kernels as K
from apex_tpu_torch.ops import multi_tensor as MT

SIZES = [128, 128 * 8, 128 * 1037]   # one row, one block row, ragged grid
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-6)


def _pair(a, name):
    """The same values as a JAX array and a torch tensor of one dtype."""
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(a, jdt)
    t = torch.from_numpy(np.array(j, np.float32)).to(tdt)
    return j, t


def _f32(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_scale_matches_jax(n, name):
    j, t = _pair(np.random.RandomState(0).randn(n), name)
    got, ginf = MT.scale(t, 0.125)
    assert got.dtype == t.dtype and ginf.dtype == torch.bool
    for want, winf in (P.scale(j, 0.125), R.scale(j, 0.125)):
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(name))
        assert bool(ginf) == bool(winf) is False
    # a device scalar factor, as the loss scaler passes 1/scale
    got2, _ = MT.scale(t, torch.tensor(0.125))
    assert torch.equal(got2, got)


@pytest.mark.parametrize("pos", [0, 64, 128 * 9 - 1])
@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
def test_scale_overflow_flag(pos, bad):
    x = np.random.RandomState(1).randn(128 * 9).astype(np.float32)
    x[pos] = bad
    _, jinf = P.scale(jnp.asarray(x), 1.0)
    _, tinf = MT.scale(torch.from_numpy(x), 1.0)
    assert bool(tinf) and bool(jinf)
    assert not bool(K.all_finite(torch.from_numpy(x)))


def _lamb_case():
    """A five-segment table (one segment of one element) and f32 buffers
    that are zero on the padding, as the flat store keeps them."""
    rs = np.random.RandomState(9)
    tree = {f"p{i}": np.zeros(s, np.float32) for i, s in
            enumerate([(1000,), (128,), (7, 11), (4096,), (1,)])}
    jt, tt = JF.make_table(tree), F.make_table(tree)
    mask = tt.valid_mask().numpy()
    g = rs.randn(jt.total).astype(np.float32) * mask
    p = rs.randn(jt.total).astype(np.float32) * mask
    m = (rs.randn(jt.total) * 0.1).astype(np.float32) * mask
    v = (np.abs(rs.randn(jt.total)) * 0.01).astype(np.float32) * mask
    return jt, tt, g, p, m, v


CASES = [  # (mode, weight_decay, use_nvlamb, max_grad_norm)
    (MT.MODE_L2, 0.0, False, 1.0),
    (MT.MODE_L2, 0.01, False, 0.0),
    (MT.MODE_L2, 0.0, True, 0.0),
    (MT.MODE_DECOUPLED, 0.0, True, 1.0),
    (MT.MODE_DECOUPLED, 0.01, False, 1.0),
    (MT.MODE_DECOUPLED, 0.01, True, 0.0),
]


@pytest.mark.parametrize("mode,wd,nvlamb,mgn", CASES)
def test_lamb_step_matches_jax(mode, wd, nvlamb, mgn):
    jt, tt, g, p, m, v = _lamb_case()
    gg = float(np.sqrt(np.sum(g.astype(np.float64) ** 2)))
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, step=3,
              weight_decay=wd, mode=mode, max_grad_norm=mgn,
              use_nvlamb=nvlamb)
    ids = jt.segment_ids()
    jargs = [jnp.asarray(a) for a in (g, p, m, v)]
    targs = [torch.from_numpy(a) for a in (g, p, m, v)]
    jp = P.lamb_step(*jargs, ids, jt.num_segments, global_grad_norm=gg,
                     **kw)
    jr = R.lamb_step(*jargs, ids, jt.num_segments, global_grad_norm=gg,
                     aligned=True, **kw)
    got = K.lamb_step(*targs, tt, aligned_segments=True,
                      global_grad_norm=torch.tensor(gg), **kw)
    again = K.lamb_step(*targs, tt, aligned_segments=True,
                        global_grad_norm=torch.tensor(gg), **kw)
    for a, b, c, d in zip(got, again, jp, jr):
        assert torch.equal(a, b)               # fixed-order sums: repeatable
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **_tol("f32"))
        np.testing.assert_allclose(a.numpy(), np.asarray(d), **_tol("f32"))
    assert not got[0][~tt.valid_mask()].any()  # padding stays zero


@pytest.mark.parametrize("asserted", [False, True])
def test_unaligned_lamb_raises_on_the_cpu_too(asserted):
    """The facade takes row-aligned segments only: a buffer not asserted
    aligned, or one whose table is not, raises rather than running a
    plain element-level path."""
    _, tt, g, p, m, v = _lamb_case()
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, step=2,
              global_grad_norm=3.0)
    t = [torch.from_numpy(a) for a in (g, p, m, v)]
    table = F.make_table({"a": np.zeros(3), "b": np.zeros(5)}, align=1) \
        if asserted else tt
    if asserted:
        t = [x[:table.total] for x in t]
    with pytest.raises(ValueError, match="row-aligned"):
        K.lamb_step(*t, table, aligned_segments=asserted, **kw)


def test_lamb_phases_compose_to_the_step():
    """lamb_step is phase 1, fixed-order segment sums, the trust ratio and
    phase 2; the sums over rows equal the sums over elements."""
    _, tt, g, p, m, v = _lamb_case()
    t = [torch.from_numpy(a) for a in (g, p, m, v)]
    sc = MT.lamb_scalars(beta1=0.9, beta2=0.999, eps=1e-6, step=1,
                         bias_correction=True, weight_decay=0.0,
                         grad_averaging=True, global_grad_norm=1.0,
                         max_grad_norm=0.0, device="cpu")
    assert sc.dtype == torch.float32 and sc.shape == (9,)
    # 1 - beta in float64, then one rounding to fp32 (multi_tensor.py:518)
    assert sc[5].item() == np.float32(1.0 - 0.999)
    u, m2, v2, prow, urow = MT.lamb_phase1(*t, sc, MT.MODE_L2)
    rows = MT.segment_sum(prow, tt.row_lengths(torch.device("cpu")))
    elems = MT.segment_sum(t[1] * t[1],
                           torch.tensor(tt.padded_sizes))
    torch.testing.assert_close(rows, elems, rtol=1e-6, atol=0)
    ratio = torch.full((tt.num_segments,), 1e-3)
    p2 = MT.lamb_phase2(t[1], u, ratio, tt.row_segment_ids())
    torch.testing.assert_close(p2, t[1] - 1e-3 * u, rtol=0, atol=0)


# -- Adam -------------------------------------------------------------------

def _adam_case(n=128 * 37, seed=11):
    rs = np.random.RandomState(seed)
    g, p = (rs.randn(n).astype(np.float32) for _ in range(2))
    m = (rs.randn(n) * 0.1).astype(np.float32)
    v = (np.abs(rs.randn(n)) * 0.01).astype(np.float32)
    return g, p, m, v


@pytest.mark.parametrize("step", [1, 7])
@pytest.mark.parametrize("mode,wd", [(MT.MODE_L2, 0.0), (MT.MODE_L2, 0.01),
                                     (MT.MODE_DECOUPLED, 0.0),
                                     (MT.MODE_DECOUPLED, 0.01)])
def test_adam_step_matches_jax_within_one_ulp(mode, wd, step):
    """The plain version (op for op the kernel's, one rounding each)
    against the JAX package's ``adam_step`` (its jnp reference): within
    one fp32 ulp. Against the Pallas kernel in interpret mode, which XLA
    compiles with fused multiply-adds: m and v within two ulps of their
    terms' magnitude (``b1·m + (1-b1)·g`` cancels; the L2 mode fuses
    ``g + wd·p`` too), so p within lr times 1e-3 of its O(1) update."""
    arrs = _adam_case(seed=step)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, step=step,
              weight_decay=wd, mode=mode)
    got = K.adam_step(*(torch.from_numpy(a) for a in arrs), **kw)
    jargs = [jnp.asarray(a) for a in arrs]
    for a, b in zip(got, R.adam_step(*jargs, **kw)):
        np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b), maxulp=1)
    p_k, m_k, v_k = (np.asarray(x) for x in P.adam_step(*jargs, **kw))
    np.testing.assert_allclose(got[0].numpy(), p_k, atol=1e-6, rtol=0)
    g, p, m, v = arrs
    gf = g + wd * p if mode == MT.MODE_L2 else g
    for t, k, terms in ((got[1], m_k, np.abs(0.9 * m) + np.abs(0.1 * gf)),
                        (got[2], v_k, 0.999 * v + 0.001 * gf * gf)):
        assert (np.abs(t.numpy() - k) <= 2 * np.spacing(terms.astype(
            np.float32))).all()


def test_adam_scalars_and_bias_correction_off():
    sc = MT.adam_scalars(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                         step=torch.tensor(2, dtype=torch.int32),
                         bias_correction=True, weight_decay=0.0,
                         device="cpu")
    assert sc.dtype == torch.float32 and sc.shape == (9,)
    # 1 - beta in float64, then one rounding (multi_tensor.py:272-275)
    assert sc[7].item() == np.float32(1.0 - 0.9) != np.float32(1) - \
        np.float32(0.9)
    assert sc[4].item() == np.float32(1) - np.float32(0.9) ** 2
    off = MT.adam_scalars(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, step=5,
                          bias_correction=False, weight_decay=0.0,
                          device="cpu")
    assert off[4].item() == off[5].item() == 1.0
    arrs = [torch.from_numpy(a) for a in _adam_case(n=256)]
    before = MT.adam.launches
    MT.adam(*arrs, sc, MT.MODE_DECOUPLED)
    assert MT.adam.launches == before          # CPU tensors: plain version


def test_fused_adam_matches_jax_over_three_steps():
    """FusedAdam's functional core (two param groups, decoupled decay in
    one) against the JAX FusedAdam; masters and slots within 1e-6."""
    from apex_tpu.optimizers import FusedAdam as JAdam
    from apex_tpu_torch.convert import opt_state_from_jax
    from apex_tpu_torch.optimizers import FusedAdam
    rs = np.random.RandomState(3)
    trees = [{"w": rs.randn(7, 11).astype(np.float32),
              "b": rs.randn(5).astype(np.float32)},
             {"e": rs.randn(300).astype(np.float32)}]
    groups = [{"params": trees[0]}, {"params": trees[1], "weight_decay": 0.1}]
    jopt = JAdam([dict(g, params={k: jnp.asarray(v) for k, v in
                                  g["params"].items()}) for g in groups],
                 lr=1e-3)
    topt = FusedAdam([dict(g, params={k: torch.from_numpy(v) for k, v in
                                      g["params"].items()}) for g in groups],
                     lr=1e-3, device="cpu")
    js = jopt.init_state()
    # both packages lay the flat buffers out alike
    ts = opt_state_from_jax(js, device="cpu")
    for a, b in zip(ts, topt.state):
        assert torch.equal(a.master, b.master)
    for _ in range(3):
        grads = [rs.randn(gs.master.shape[0]).astype(np.float32)
                 * F_valid(t) for gs, t in zip(js, topt._tables)]
        js = jopt.apply_update(js, [jnp.asarray(g) for g in grads])
        ts = topt.apply_update(ts, [torch.from_numpy(g) for g in grads])
    for a, b in zip(ts, js):
        assert int(a.step) == int(np.asarray(b.step)) == 3
        np.testing.assert_allclose(a.master.numpy(), np.asarray(b.master),
                                   atol=1e-6, rtol=0)
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(a.slots[k].numpy(),
                                       np.asarray(b.slots[k]), atol=1e-6,
                                       rtol=0)


def F_valid(table):
    return table.valid_mask().numpy()
