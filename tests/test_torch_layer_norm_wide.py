"""Port parity: the wide LayerNorm (rows of F > 8192).

The port's ``ln_fwd`` / ``ln_bwd`` on CPU tensors (their plain versions,
which the wide CUDA kernels are held against on the card) against the JAX
package's ``ln_fwd`` / ``ln_bwd``, which take ``_ln_fwd_wide`` /
``_ln_bwd_wide`` at these widths, in interpret mode under
``dispatch.backend("pallas")`` as tests/test_fused_layer_norm.py runs
them, on the same numpy inputs; the JAX tests' shapes. Tolerances: y,
mean and invvar 1e-5 (fp32 sums in another order); the gamma/beta
gradients within 1e-4 of each column's sum of |terms|, and dx within 1e-4
of the sum of its own terms' magnitudes, the JAX kernels carrying their
sums across 1024-wide tiles. The large-mean case against
fp64, and the module over a two-dim ``normalized_shape`` through autograd
against ``jax.grad``. The one-pass backward's launch plan
(``csrc/ln_row_plan.cuh``, host code) built by the host's C++ compiler.
"""

import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization import fused_layer_norm_affine as j_ln
from apex_tpu.ops import dispatch as jdispatch
from apex_tpu.ops.pallas import layer_norm as JP
from apex_tpu_torch.normalization import FusedLayerNorm, fused_layer_norm
from apex_tpu_torch.ops import layer_norm as OPS

CSRC = Path(OPS.__file__).resolve().parent / "cuda" / "csrc"


def _data(rows, f, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(rows, f) * 2.0 + 0.5).astype(np.float32)
    dy = rs.randn(rows, f).astype(np.float32)
    w = (rs.randn(f) + 1.0).astype(np.float32)
    b = np.linspace(-1, 1, f).astype(np.float32)
    return x, dy, w, b


def _within(got, want, bound):
    err = np.abs(got - np.asarray(want, np.float32))
    assert (err <= bound).all(), float((err / bound).max())


def _cols_close(got, want, terms):
    """A column sum within 1e-4 of its column's sum of |terms|."""
    _within(got, want, 1e-4 * np.abs(terms).sum(axis=0) + 1e-6)


@pytest.mark.parametrize("rows,f,affine", [(13, 9344, True),
                                           (13, 16384, True),
                                           (520, 9344, True),
                                           (9, 10240, False),
                                           (13, 12290, True),
                                           (7, 12289, True),
                                           (7, 8193, True),
                                           (5, 16385, True)])
def test_wide_fwd_bwd_match_jax_pallas(rows, f, affine):
    assert f > OPS.F_SINGLE_MAX
    x, dy, w, b = _data(rows, f, seed=rows + f)
    wj, bj = (jnp.asarray(w), jnp.asarray(b)) if affine else (None, None)
    with jdispatch.backend("pallas"):
        y_j, mean_j, inv_j = JP.ln_fwd(jnp.asarray(x), wj, bj, 1e-5)
    wt, bt = (torch.from_numpy(w), torch.from_numpy(b)) if affine \
        else (None, None)
    before = (OPS.ln_fwd_wide.launches, OPS.ln_bwd_wide.launches)
    y, mean, inv = OPS.ln_fwd(torch.from_numpy(x), wt, bt, 1e-5)
    for got, want in ((y, y_j), (mean, mean_j), (inv, inv_j)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    # the backward from one set of statistics (the port's)
    with jdispatch.backend("pallas"):
        want = JP.ln_bwd(jnp.asarray(dy), jnp.asarray(x), wj,
                         jnp.asarray(mean.numpy()), jnp.asarray(inv.numpy()))
    got = OPS.ln_bwd(torch.from_numpy(dy), torch.from_numpy(x), wt, mean,
                     inv)
    assert (OPS.ln_fwd_wide.launches, OPS.ln_bwd_wide.launches) == before
    assert len(want) == (3 if affine else 1)
    xhat = (x - mean.numpy()[:, None]) * inv.numpy()[:, None]
    dxh = dy * w if affine else dy
    m2 = (dxh * xhat).mean(1, keepdims=True)
    # dx = inv·(dxhat − m1 − xhat·m2): within 1e-4 of its terms' sum
    dx_terms = inv.numpy()[:, None] * (np.abs(dxh) + np.abs(
        dxh.mean(1, keepdims=True)) + np.abs(xhat * m2))
    _within(got[0].numpy(), want[0], 1e-4 * dx_terms + 1e-6)
    if affine:
        _cols_close(got[1].numpy(), want[1], dy * xhat)
        _cols_close(got[2].numpy(), want[2], dy)
    else:
        assert got[1] is None and got[2] is None


def _slot_cols(vec: int, lane: int, kind: str) -> list:
    """The chunk column of each of a lane's 32 register slots in
    csrc/layer_norm.cu's wide kernels: as loaded (group i of ``wide_col``
    fills slots i·VEC to i·VEC + VEC − 1 from its column on) and as the
    backward's column sums are stored (``store_block_cols``: slot r to
    wide_col(r / VEC, lane) + r % VEC)."""
    if kind == "load":
        return [(i * 32 + lane) * vec + e for i in range(32 // vec)
                for e in range(vec)]
    return [(r // vec * 32 + lane) * vec + r % vec for r in range(32)]


@pytest.mark.parametrize("f", [16386, 24578, 16388])
def test_two_wide_columns_stay_fixed_across_rows(f):
    """The VEC-2 form of the chunked wide backward (F > 16384): a lane's
    register slots map to the same chunk columns when loaded and when its
    column sums are stored,
    the lanes cover each of the chunk's 1024 columns once, and no row
    enters the map, so the sums of dy·xhat and dy stay in registers across
    the block's rows. Every 2-wide group starts 2-element aligned in every
    row of an even F; the 4-wide groups start 4-element aligned in every
    row only where F % 4 == 0 (at F % 4 == 2 odd rows are 2 off)."""
    for vec in (1, 2, 4):
        per_lane = [_slot_cols(vec, lane, "load") for lane in range(32)]
        assert per_lane == [_slot_cols(vec, lane, "store")
                            for lane in range(32)]
        assert sorted(c for cols in per_lane for c in cols) == list(
            range(1024))
    nchunk = -(-f // 1024)
    starts = [(row * f + j * 1024 + (i * 32 + lane) * 2) for row in range(5)
              for j in range(nchunk) for i in range(16) for lane in range(32)
              if j * 1024 + (i * 32 + lane) * 2 < f]
    assert all(x % 2 == 0 for x in starts)
    starts4 = {(row * f + (i * 32 + lane) * 4) % 4 for row in range(5)
               for i in range(8) for lane in range(32)}
    assert starts4 == ({0} if f % 4 == 0 else {0, 2})


def _r16(n):
    return -(-n // 16) * 16


_PLAN_MAIN = r"""
#include <cstdio>
#include "ln_row_plan.cuh"
int main() {
  long long rows, bases;
  int f, xs, ws;
  while (std::scanf("%lld %d %d %d %lld", &rows, &f, &xs, &ws, &bases)
         == 5) {
    const apex_port::RowPlan p = apex_port::row_plan(rows, f, xs, ws);
    std::printf("%d %d %d %d %d\n", p.cluster, p.stages, p.clusters,
                p.smem, apex_port::row_vec(f, xs, (uintptr_t)bases));
  }
}
"""


@pytest.fixture(scope="module")
def row_plan(tmp_path_factory):
    """``csrc/ln_row_plan.cuh`` built alone by the host's C++ compiler (it
    needs no CUDA header): the one-pass wide backward's launch, as the C
    entry computes it, for a list of (rows, F, x's and gamma's element
    sizes, the buffers' or-ed addresses) -> (cluster, stages, clusters,
    shared memory, load width)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("ln_row_plan")
    (d / "main.cpp").write_text(_PLAN_MAIN)
    subprocess.run([cxx, "-std=c++17", "-I", str(CSRC), str(d / "main.cpp"),
                    "-o", str(d / "plan")], check=True, capture_output=True,
                   timeout=120)

    def plan(cases):
        got = subprocess.run(
            [str(d / "plan")], capture_output=True, text=True, check=True,
            timeout=60, input="".join(" ".join(map(str, c)) + "\n"
                                      for c in cases)).stdout.split()
        vals = [int(v) for v in got]
        return [tuple(vals[k:k + 5]) for k in range(0, len(vals), 5)]
    return plan


@pytest.mark.parametrize("f", [1, 8193, 9344, 11600, 12288, 12289, 12290,
                               16383, 16384])
@pytest.mark.parametrize("x_size,w_size", [(2, 2), (2, 4), (2, 0), (4, 4),
                                           (4, 0)])
def test_row_plan_fits_and_depends_on_the_shape_only(row_plan, f, x_size,
                                                      w_size):
    """The one-pass wide backward's launch from the shape and the element
    sizes alone: a block's shared memory (512 bytes of head, gamma's
    segment, the stages' two buffers each 16 bytes over for the row's
    offset in its chunk) within 227 KB; two to four stages; a whole row a
    block wherever two stages of it fit, else halves split at a multiple of
    8 columns in 2-block clusters (never for 16-bit rows); min(rows, 132 /
    cluster) clusters, so no block goes without a row and no more than 132
    run. The load width: the widest of 16 bytes, 8, 4, 2 and 1 values that
    divides F and the buffers' addresses."""
    rows_all = (1, 7, 133, 8192)
    cases = [(rows, f, x_size, w_size, bases) for rows in rows_all
             for bases in (0, x_size, 2 * x_size, 4 * x_size)]
    got = row_plan(cases + cases)
    assert got[:len(cases)] == got[len(cases):]
    for (rows, _, _, _, bases), (cluster, stages, clusters, smem,
                                 vec) in zip(cases, got):
        n = f if cluster == 1 else ((f + 1) // 2 + 7) // 8 * 8
        span = _r16(n * x_size) + 16
        assert smem == 512 + _r16(n * w_size) + 2 * span * stages
        assert smem <= 232448 and 2 <= stages <= 4
        whole = 512 + _r16(f * w_size) + 4 * (_r16(f * x_size) + 16)
        assert cluster == (1 if whole <= 232448 else 2)
        if cluster == 2:
            assert x_size == 4 and n % 8 == 0 and 0 < f - n <= n
        assert clusters == min(rows, 132 // cluster)
        assert vec == max(v for v in (1, 2, 4, 8) if v * x_size <= 16
                          and f % v == 0 and bases % (v * x_size) == 0)


@pytest.mark.parametrize("rows,f,x_size,w_size,plan", [
    (8192, 12288, 2, 2, (1, 4, 132, 221824, 8)),     # the wide LM, bf16
    (8192, 12289, 2, 2, (1, 4, 132, 221968, 1)),
    (8192, 12290, 2, 2, (1, 4, 132, 221968, 2)),
    (8192, 16384, 2, 2, (1, 3, 132, 229984, 8)),
    (8192, 16384, 2, 4, (1, 2, 132, 197184, 8)),     # bf16, fp32 gamma
    (520, 9344, 4, 4, (1, 2, 132, 187456, 4)),       # the JAX tests' fp32
    (13, 16384, 4, 4, (2, 3, 13, 229984, 4)),
    (8192, 12290, 4, 4, (2, 4, 66, 222112, 2)),
    (8192, 12290, 4, 0, (1, 2, 132, 197248, 2))])    # no gamma: two fit
def test_row_plan_at_the_readings(row_plan, rows, f, x_size, w_size, plan):
    """The launches of chip_smoke.py's readings, as the source note gives
    them: fp32 rows past about 11,600 values go to 2-block clusters."""
    assert row_plan([(rows, f, x_size, w_size, 0)]) == [plan]


def test_wide_forward_holds_a_large_mean():
    """x = 1000 + 0.01·N(0, 1): within 0.05 of fp64 (the JAX test's bar,
    tests/test_fused_layer_norm.py:201-216), finite, as the JAX wide
    path's is."""
    rs = np.random.RandomState(7)
    x = (1000.0 + 0.01 * rs.randn(9, 16384)).astype(np.float32)
    xd = x.astype(np.float64)
    ref = (xd - xd.mean(1, keepdims=True)) / np.sqrt(
        xd.var(1, keepdims=True) + 1e-5)
    y = fused_layer_norm(torch.from_numpy(x), 16384, eps=1e-5).numpy()
    with jdispatch.backend("pallas"):
        y_j, _, _ = JP.ln_fwd(jnp.asarray(x), None, None, 1e-5)
    for out in (y, np.asarray(y_j)):
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, ref, atol=0.05)


def test_module_over_a_two_dim_shape_matches_jax_grad():
    """``FusedLayerNorm((73, 128))`` over [2, 3, 73, 128] (rows of 9344)
    through autograd against ``fused_layer_norm_affine`` and
    ``jax.grad`` on the pallas path."""
    rs = np.random.RandomState(11)
    x = (rs.randn(2, 3, 73, 128) * 2.0 + 0.5).astype(np.float32)
    dy = rs.randn(2, 3, 73, 128).astype(np.float32)
    w = (rs.randn(73, 128) + 1.0).astype(np.float32)
    b = rs.randn(73, 128).astype(np.float32)

    def jloss(x_, w_, b_):
        return jnp.sum(j_ln(x_, (73, 128), w_, b_, 1e-5) * jnp.asarray(dy))

    with jdispatch.backend("pallas"):
        y_j = j_ln(jnp.asarray(x), (73, 128), jnp.asarray(w),
                   jnp.asarray(b), 1e-5)
        gx_j, gw_j, gb_j = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    mod = FusedLayerNorm((73, 128), eps=1e-5, device="cpu")
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w))
        mod.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = mod(xt)
    gx, gw, gb = torch.autograd.grad(y, (xt, mod.weight, mod.bias),
                                     torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               atol=1e-5, rtol=1e-5)
    assert gw.shape == gb.shape == (73, 128)
    for got, want in ((gx, gx_j), (gw, gw_j), (gb, gb_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
