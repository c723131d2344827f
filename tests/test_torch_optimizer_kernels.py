"""Port parity: the per-row norm, SGD and NovoGrad ops of the ImageNet
step (``apex_tpu_torch.ops.multi_tensor`` and the ``ops.kernels`` facade).

The plain versions — what a CPU tensor runs, and what the CUDA kernels
are held against on the card — against the JAX package's Pallas kernels
in interpret mode (``P.rowsumsq``, ``P.rowmaxabs``, ``P.sgd_step``,
``P.novograd_step``, as tests/test_pallas_kernels.py runs them) and its
jnp reference (``R``), on the same numpy inputs. Tolerances are
test_pallas_kernels.py:30-32's: rtol 2e-5 / atol 2e-6 in f32, 2e-2 in
bf16; a row's max |x| is exact.
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
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# -- the per-row norms ----------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_rowsumsq_matches_jax(n, name):
    j, t = _pair(np.random.RandomState(n).randn(n) * 3, name)
    got = MT.rowsumsq(t)
    assert got.dtype == torch.float32 and got.shape == (n // 128,)
    for want in (P.rowsumsq(j),
                 jnp.sum(jnp.square(j.astype(jnp.float32)).reshape(-1, 128),
                         axis=1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **_tol("float32"))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_rowmaxabs_matches_jax_exactly(n, name):
    j, t = _pair(np.random.RandomState(n + 1).randn(n) * 3, name)
    got = MT.rowmaxabs(t)
    assert got.dtype == torch.float32 and got.shape == (n // 128,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(P.rowmaxabs(j)))


def test_rowmaxabs_lets_nan_through():
    x = torch.ones(256)
    x[130] = float("nan")
    x[5] = float("-inf")
    out = MT.rowmaxabs(x)
    assert out[0].item() == float("inf") and torch.isnan(out[1])


def _table_case(seed=9):
    """A five-segment table (one segment of one element) and f32 buffers
    that are zero on the padding, as the flat store keeps them."""
    rs = np.random.RandomState(seed)
    tree = {f"p{i}": np.zeros(s, np.float32) for i, s in
            enumerate([(1000,), (128,), (7, 11), (4096,), (1,)])}
    jt, tt = JF.make_table(tree), F.make_table(tree)
    mask = tt.valid_mask().numpy()
    g = rs.randn(jt.total).astype(np.float32) * mask
    p = rs.randn(jt.total).astype(np.float32) * mask
    m = (rs.randn(jt.total) * 0.1).astype(np.float32) * mask
    return jt, tt, g, p, m


@pytest.mark.parametrize("name", list(DTYPES))
def test_per_segment_norms_match_jax(name):
    jt, tt, g, _, _ = _table_case()
    j, t = _pair(g, name)
    ids, s = jt.segment_ids(), jt.num_segments
    l2 = K.l2norm_per_segment(t, tt, aligned_segments=True)
    mx = K.maxnorm_per_segment(t, tt, aligned_segments=True)
    assert l2.shape == mx.shape == (s,)
    for want in (P.l2norm_per_segment(j, ids, s),
                 R.l2norm_per_segment(j, ids, s, aligned=True)):
        np.testing.assert_allclose(l2.numpy(), np.asarray(want),
                                   **_tol("float32"))
    for want in (P.maxnorm_per_segment(j, ids, s),
                 R.maxnorm_per_segment(j, ids, s, aligned=True)):
        np.testing.assert_array_equal(mx.numpy(), np.asarray(want))


def test_segment_max_of_an_empty_segment_is_zero():
    """reference.py:155-168: an empty segment reports 0, not -inf."""
    vals = torch.tensor([1.0, 3.0, 2.0])
    out = MT.segment_max(vals, torch.tensor([2, 0, 1]))
    assert out.tolist() == [3.0, 0.0, 2.0]
    want = R.maxnorm_per_segment(jnp.asarray([1.0, -3.0, 2.0]),
                                 jnp.asarray([0, 0, 2]), 3)
    assert np.asarray(want).tolist() == out.tolist()


@pytest.mark.parametrize("fn", ["l2norm_per_segment", "maxnorm_per_segment",
                                "novograd_step"])
@pytest.mark.parametrize("asserted", [False, True])
def test_unaligned_norms_raise_on_the_cpu_too(fn, asserted):
    """The facade takes row-aligned segments only, as for LAMB."""
    _, tt, g, p, m = _table_case()
    table = F.make_table({"a": np.zeros(3), "b": np.zeros(5)}, align=1) \
        if asserted else tt
    x = torch.from_numpy(g[:table.total])
    args = (x, table) if fn != "novograd_step" else (
        x, x, x, torch.zeros(table.num_segments), table)
    kw = {} if fn != "novograd_step" else dict(
        lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, step=1)
    with pytest.raises(ValueError, match="row-aligned"):
        getattr(K, fn)(*args, aligned_segments=asserted, **kw)


# -- SGD ------------------------------------------------------------------------

SGD_CASES = [  # (momentum, dampening, nesterov, wd_after_momentum, wd)
    (0.9, 0.0, False, False, 1e-4),       # main_amp's defaults
    (0.9, 0.0, True, False, 1e-4),
    (0.9, 0.0, False, True, 1e-4),
    (0.9, 0.0, True, True, 1e-4),
    (0.9, 0.1, False, False, 0.0),
    (0.0, 0.0, False, False, 1e-2),       # no momentum
]


@pytest.mark.parametrize("first_run", [False, True])
@pytest.mark.parametrize("mom,damp,nesterov,after,wd", SGD_CASES)
@pytest.mark.parametrize("name", list(DTYPES))
def test_sgd_step_matches_jax(name, mom, damp, nesterov, after, wd,
                              first_run):
    rs = np.random.RandomState(17)
    n = 128 * 37
    g = rs.randn(n).astype(np.float32)
    (jp, tp), (jm, tm) = (_pair(rs.randn(n) * s, name) for s in (1.0, 0.1))
    kw = dict(wd=wd, momentum=mom, dampening=damp, lr=0.1,
              nesterov=nesterov, wd_after_momentum=after)
    got = K.sgd_step(torch.from_numpy(g), tp, tm,
                     first_run=torch.tensor(first_run), **kw)
    assert got[0].dtype == tp.dtype and got[1].dtype == tm.dtype
    jg = jnp.asarray(g)
    for want in (P.sgd_step(jg, jp, jm, first_run=jnp.asarray(first_run),
                            **kw),
                 R.sgd_step(jg, jp, jm, first_run=first_run, **kw)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(_f32(a), _f32(b), **_tol(name))
    if mom == 0.0:
        assert torch.equal(got[1], tm)         # the buffer stays as it was


def test_sgd_scalars_and_flags():
    sc = MT.sgd_scalars(wd=1e-4, lr=0.1, momentum=0.9, dampening=0.1,
                        first_run=torch.tensor(True), device="cpu")
    assert sc.dtype == torch.float32 and sc.shape == (6,)
    # 1 - dampening in float64, then one rounding to fp32
    assert sc[3].item() == np.float32(1.0 - 0.1)
    assert sc[4].item() == 1.0 and sc[5].item() == 1.0
    flags = MT._sgd_flags(wd=0.0, momentum=0.9, nesterov=True,
                          wd_after_momentum=True)
    assert flags == MT.SGD_MOMENTUM | MT.SGD_NESTEROV | MT.SGD_WD_AFTER
    assert MT._sgd_flags(wd=1e-4, momentum=0.0, nesterov=False,
                         wd_after_momentum=False) == MT.SGD_WD


# -- NovoGrad -------------------------------------------------------------------

@pytest.mark.parametrize("bias_correction,grad_averaging",
                         [(True, True), (False, False)])
@pytest.mark.parametrize("mode", [MT.MODE_L2, MT.MODE_DECOUPLED])
@pytest.mark.parametrize("norm_type", [MT.NORM_LINF, MT.NORM_L2])
def test_novograd_step_matches_jax(norm_type, mode, bias_correction,
                                   grad_averaging):
    jt, tt, g, p, m = _table_case(seed=21)
    v = np.abs(np.random.RandomState(5).randn(jt.num_segments)).astype(
        np.float32)
    kw = dict(lr=1e-2, beta1=0.95, beta2=0.98, eps=1e-8, step=3,
              bias_correction=bias_correction, weight_decay=1e-3,
              grad_averaging=grad_averaging, mode=mode,
              norm_type=norm_type)
    targs = [torch.from_numpy(a) for a in (g, p, m, v)]
    got = K.novograd_step(*targs, tt, aligned_segments=True, **kw)
    jargs = [jnp.asarray(a) for a in (g, p, m, v)]
    ids = jt.segment_ids()
    for want in (P.novograd_step(*jargs, ids, **kw),
                 R.novograd_step(*jargs, ids, aligned=True, **kw)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **_tol("float32"))
    assert not got[0][~tt.valid_mask()].any()  # padding stays zero
    # norms the caller took once give the same step
    norms = (K.maxnorm_per_segment if norm_type == MT.NORM_LINF
             else K.l2norm_per_segment)(targs[0], tt, aligned_segments=True)
    again = K.novograd_step(*targs, tt, aligned_segments=True,
                            grad_norms=norms, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_norm_out_blend_matches_jax():
    rs = np.random.RandomState(2)
    old, new = (np.abs(rs.randn(7)).astype(np.float32) for _ in range(2))
    for nt in (MT.NORM_LINF, MT.NORM_L2):
        got = K.norm_out_blend(torch.from_numpy(old), torch.from_numpy(new),
                               0.98, 1.0 - 0.98, nt)
        want = R.norm_out_blend(jnp.asarray(old), jnp.asarray(new), 0.98,
                                1.0 - 0.98, nt)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-7, atol=0)


def test_cpu_tensors_run_the_plain_versions():
    _, tt, g, p, m = _table_case()
    t = [torch.from_numpy(a) for a in (g, p, m)]
    fns = (MT.rowsumsq, MT.rowmaxabs, MT.sgd, MT.novograd)
    before = [f.launches for f in fns]
    MT.l2norm_per_segment(t[0], tt)
    MT.maxnorm_per_segment(t[0], tt)
    MT.sgd_step(*t, wd=0.0, momentum=0.9, dampening=0.0, lr=0.1)
    MT.novograd_step(*t, torch.zeros(tt.num_segments), tt, lr=1e-3,
                     beta1=0.9, beta2=0.999, eps=1e-8, step=1)
    assert [f.launches for f in fns] == before
