"""Multi-tensor ops over the flat buffer: the kernel wrappers and their
plain PyTorch versions.

Counterpart of ``apex_tpu/ops/pallas/multi_tensor.py`` (the kernels) and
``apex_tpu/ops/reference.py`` (the plain versions) for the ops the RN50
FusedLAMB step runs; the kernels are ``ops/cuda/csrc/multi_tensor.cu``:

- :func:`scale` replaces ``scale`` → ``_scale_kernel`` (multi_tensor.py:96):
  ``x * s`` and a found_inf flag read from the input;
- :func:`lamb_phase1` / :func:`lamb_phase2` replace ``lamb_step`` →
  ``_lamb_phase1_kernel`` / ``_lamb_phase2_kernel`` (multi_tensor.py:452,
  :480); :func:`lamb_step` joins them with the per-tensor trust ratio;
- :func:`adam` replaces ``adam_step`` → ``_adam_kernel`` (multi_tensor.py:
  270); :func:`adam_step` adds its scalars;
- :func:`rowsumsq` / :func:`rowmaxabs` replace ``rowsumsq`` →
  ``_rowsumsq_kernel`` (:197) and ``rowmaxabs`` → ``_rowmaxabs_kernel``
  (:219): the per-row stage of the per-tensor norms, which
  :func:`l2norm_per_segment` and :func:`maxnorm_per_segment` finish with a
  fixed-order sum or a max over each segment's rows;
- :func:`sgd` replaces ``sgd_step`` → ``_sgd_kernel`` (:354);
  :func:`sgd_step` adds its scalars;
- :func:`novograd` replaces ``novograd_step`` → ``_novograd_kernel``
  (:393); :func:`novograd_step` adds the per-tensor norm blend and the
  bias corrections, plain on the device;
- :func:`axpby` replaces ``axpby`` → ``_axpby_kernel`` (:127): ``a·x +
  b·y`` with the overflow flag on x, y or both (gradient accumulation);
- :func:`l2norm` replaces ``l2norm`` → ``_sumsq_kernel`` (:169): the
  global fp32 L2 norm as a device scalar (gradient clipping);
- :func:`adagrad` replaces ``adagrad_step`` → ``_adagrad_kernel``
  (:322); :func:`adagrad_step` adds its scalars.

For a tensor on the CPU each wrapper runs its plain version; for a tensor
on the card it launches its kernel, or raises on what the kernel does not
take. Scalars the step computes on the device (the unscale factor, the
bias corrections, the clip factor) reach the kernels as a pointer to a
small fp32 device array, so nothing here waits for the card. Each wrapper
counts its launches in ``.launches``.
"""

from __future__ import annotations

import functools

import torch

from apex_tpu_torch.ops import cuda as _cuda
from apex_tpu_torch.ops import dispatch
from apex_tpu_torch.ops.flat import LANES, SegmentTable

__all__ = ["MODE_L2", "MODE_DECOUPLED", "all_finite", "scale", "scale_plain",
           "segment_sum", "lamb_scalars", "lamb_phase1", "lamb_phase1_plain",
           "lamb_phase2", "lamb_phase2_plain", "lamb_step",
           "lamb_step_plain", "adam_scalars", "adam", "adam_plain",
           "adam_step", "NORM_LINF", "NORM_L2", "rowsumsq", "rowsumsq_plain",
           "rowmaxabs", "rowmaxabs_plain", "segment_max",
           "l2norm_per_segment", "maxnorm_per_segment", "norm_out_blend",
           "sgd_scalars", "sgd", "sgd_plain", "sgd_step",
           "novograd_scalars", "novograd", "novograd_plain",
           "novograd_step", "axpby", "axpby_plain", "l2norm", "l2norm_plain",
           "adagrad_scalars", "adagrad", "adagrad_plain", "adagrad_step"]

MODE_L2 = 0          # weight decay folded into the gradient
MODE_DECOUPLED = 1   # AdamW-style decoupled weight decay
NORM_LINF = 0        # per-tensor max |x| (reference.py:36)
NORM_L2 = 2          # per-tensor L2 norm

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def all_finite(*tensors: torch.Tensor) -> torch.Tensor:
    """Device bool: every element of every tensor is finite."""
    ok = torch.ones((), dtype=torch.bool, device=tensors[0].device)
    for t in tensors:
        ok = ok & torch.isfinite(t.float()).all()
    return ok


def _check_flat(what: str, t: torch.Tensor, device, align_elems: int = 4):
    if t.device != device:
        raise ValueError(f"{what}: tensors must share one device")
    if t.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what}: dtype {t.dtype} is not supported by the "
                        f"kernel (float32, bfloat16)")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensors must be contiguous")
    if t.data_ptr() % (align_elems * t.element_size()):
        raise ValueError(f"{what}: buffer must be {align_elems}-element "
                         f"aligned for the vector loads")


def _as_device_scalar(s, device) -> torch.Tensor:
    if isinstance(s, torch.Tensor):
        if s.device != device or s.numel() != 1:
            raise ValueError("scale factor must be one value on the "
                             "tensor's device")
        return s.reshape(1).to(torch.float32)
    return torch.full((1,), float(s), dtype=torch.float32, device=device)


# -- scale (K4) ---------------------------------------------------------------

def scale_plain(x: torch.Tensor, scale_factor):
    """Plain version (reference.py:60-67): fp32 ``x * s`` in x's dtype, and
    a device bool that is True when any input element is not finite."""
    xf = x.float()
    out = (xf * scale_factor).to(x.dtype)
    return out, ~torch.isfinite(xf).all()


def scale(x: torch.Tensor, scale_factor):
    """``(x * scale_factor, found_inf)``; ``scale_factor`` is a float or a
    one-element fp32 tensor on x's device."""
    if not dispatch.use_kernel(x):
        return scale_plain(x, scale_factor)
    if x.dim() != 1:
        raise ValueError("scale: x must be a flat 1-D buffer")
    _check_flat("scale", x, x.device, align_elems=1)
    s = _as_device_scalar(scale_factor, x.device)
    out = torch.empty_like(x)
    flag = torch.zeros(1, dtype=torch.int32, device=x.device)
    if x.numel():
        err = _cuda.lib().apex_scale(
            _cuda.dtype_code(x.dtype, "scale"), x.data_ptr(), out.data_ptr(),
            s.data_ptr(), flag.data_ptr(), x.numel(), _cuda.stream(x.device))
        _cuda.check(err, "scale")
        scale.launches += 1
    return out, flag[0] != 0


scale.launches = 0


# -- LAMB (K5, K6) ------------------------------------------------------------

def segment_sum(vals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sum of each segment of contiguous ``vals`` (``lengths`` int64 on
    the same device). Fixed order — no float atomics — so the per-tensor
    norms, and with them the trust ratios, repeat bit for bit."""
    return torch.segment_reduce(vals, "sum", lengths=lengths)


@functools.lru_cache(maxsize=None)
def _consts(values: tuple, device: torch.device) -> torch.Tensor:
    # one host-to-device copy per hyperparameter set, not per step
    return torch.tensor(values, dtype=torch.float32).to(device)


def lamb_scalars(*, beta1: float, beta2: float, eps: float, step,
                 bias_correction: bool, weight_decay: float,
                 grad_averaging: bool, global_grad_norm,
                 max_grad_norm: float, device) -> torch.Tensor:
    """The phase-1 scalars as one fp32 [9] device array:
    ``[b1, b2, eps, wd, beta3, 1-b2, bc1, bc2, clip]``. ``1-b1`` and
    ``1-b2`` are taken in float64, then rounded to fp32, as
    multi_tensor.py:518-519 does; ``bc1``, ``bc2`` (from the device step)
    and ``clip`` (from the global norm) stay on the device."""
    device = torch.device(device)
    beta3 = (1.0 - beta1) if grad_averaging else 1.0
    const = _consts((beta1, beta2, eps, weight_decay, beta3, 1.0 - beta2),
                    device)
    stepf = torch.as_tensor(step, device=device).to(torch.float32)
    if bias_correction:
        bc1 = 1.0 - torch.pow(const[0], stepf)
        bc2 = 1.0 - torch.pow(const[1], stepf)
    else:
        bc1 = bc2 = torch.ones((), dtype=torch.float32, device=device)
    gg = torch.as_tensor(global_grad_norm, device=device).to(torch.float32)
    if max_grad_norm > 0:
        clip = torch.where(gg > max_grad_norm, gg / max_grad_norm,
                           torch.ones_like(gg))
    else:
        clip = torch.ones((), dtype=torch.float32, device=device)
    return torch.cat([const, torch.stack([bc1.reshape(()), bc2.reshape(()),
                                          clip.reshape(())])])


def _lamb_update(g, p, m, v, sc: torch.Tensor, mode: int):
    """fp32 ``(p, u, m, v)`` of LAMB's first phase; each operation rounds
    once, in the kernel's order."""
    b1, b2, eps, wd, beta3, omb2, bc1, bc2, clip = sc.unbind()
    gf = g.float() / clip
    pf = p.float()
    if mode == MODE_L2:
        gf = gf + wd * pf
    mf = b1 * m.float() + beta3 * gf
    vf = b2 * v.float() + omb2 * gf * gf
    u = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
    if mode == MODE_DECOUPLED:
        u = u + wd * pf
    return pf, u, mf, vf


def lamb_phase1_plain(g, p, m, v, sc: torch.Tensor, mode: int):
    """Plain version of ``_lamb_phase1_kernel`` (multi_tensor.py:452-477):
    the fp32 update term u, new m and v in their storage dtype, and the
    per-row sums of p² and u²."""
    pf, u, mf, vf = _lamb_update(g, p, m, v, sc, mode)
    prow = (pf * pf).view(-1, LANES).sum(dim=1)
    urow = (u * u).view(-1, LANES).sum(dim=1)
    return u, mf.to(m.dtype), vf.to(v.dtype), prow, urow


def lamb_phase1(g, p, m, v, sc: torch.Tensor, mode: int):
    """Phase 1 of LAMB over flat buffers of ``rows * 128`` elements;
    returns ``(u, m, v, prow, urow)`` like :func:`lamb_phase1_plain`."""
    if not dispatch.use_kernel(p):
        return lamb_phase1_plain(g, p, m, v, sc, mode)
    n = p.numel()
    if n % LANES or g.shape != p.shape or m.shape != p.shape \
            or v.shape != p.shape or p.dim() != 1:
        raise ValueError(f"lamb_phase1: g, p, m, v must be flat buffers of "
                         f"one length, a multiple of {LANES}")
    for what, t in (("g", g), ("p", p), ("m", m), ("v", v)):
        _check_flat(f"lamb_phase1 {what}", t, p.device)
    if m.dtype != p.dtype or v.dtype != p.dtype:
        raise TypeError("lamb_phase1: p, m and v must share one dtype")
    if sc.dtype != torch.float32 or sc.numel() != 9 or sc.device != p.device:
        raise ValueError("lamb_phase1: scalars must be fp32 [9] on the card")
    rows = n // LANES
    u = torch.empty(n, dtype=torch.float32, device=p.device)
    m_out, v_out = torch.empty_like(m), torch.empty_like(v)
    sums = torch.empty((2, rows), dtype=torch.float32, device=p.device)
    if rows:
        err = _cuda.lib().apex_lamb_phase1(
            _cuda.dtype_code(g.dtype, "lamb g"),
            _cuda.dtype_code(p.dtype, "lamb p"), g.data_ptr(), p.data_ptr(),
            m.data_ptr(), v.data_ptr(), u.data_ptr(), m_out.data_ptr(),
            v_out.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
            sc.contiguous().data_ptr(), rows, int(mode),
            _cuda.stream(p.device))
        _cuda.check(err, "lamb_phase1")
        lamb_phase1.launches += 1
    return u, m_out, v_out, sums[0], sums[1]


lamb_phase1.launches = 0


def lamb_phase2_plain(p, u, ratio, row_seg):
    """Plain version of ``_lamb_phase2_kernel`` (multi_tensor.py:480-483):
    ``p - ratio[segment of the row] * u`` in p's dtype."""
    r = ratio[row_seg.long()][:, None]
    pf = p.float().view(-1, LANES)
    return (pf - r * u.view(-1, LANES)).view(-1).to(p.dtype)


def lamb_phase2(p, u, ratio, row_seg):
    """Phase 2 of LAMB: p [rows*128] (fp32 or bf16), u fp32 of the same
    length, ratio fp32 [segments], row_seg int32 [rows]."""
    if not dispatch.use_kernel(p):
        return lamb_phase2_plain(p, u, ratio, row_seg)
    n = p.numel()
    if n % LANES or u.shape != p.shape or p.dim() != 1:
        raise ValueError(f"lamb_phase2: p and u must be flat buffers of one "
                         f"length, a multiple of {LANES}")
    _check_flat("lamb_phase2 p", p, p.device)
    _check_flat("lamb_phase2 u", u, p.device)
    if u.dtype != torch.float32 or ratio.dtype != torch.float32:
        raise TypeError("lamb_phase2: u and ratio must be float32")
    if row_seg.dtype != torch.int32 or row_seg.numel() != n // LANES:
        raise ValueError("lamb_phase2: row_seg must be int32 [rows]")
    for t in (ratio, row_seg):
        if t.device != p.device or not t.is_contiguous():
            raise ValueError("lamb_phase2: ratio and row_seg must be "
                             "contiguous on p's device")
    out = torch.empty_like(p)
    if n:
        err = _cuda.lib().apex_lamb_phase2(
            _cuda.dtype_code(p.dtype, "lamb p"), p.data_ptr(), u.data_ptr(),
            ratio.data_ptr(), row_seg.data_ptr(), out.data_ptr(), n // LANES,
            _cuda.stream(p.device))
        _cuda.check(err, "lamb_phase2")
        lamb_phase2.launches += 1
    return out


lamb_phase2.launches = 0


def _trust_ratio(pn, un, lr, use_nvlamb: bool, weight_decay: float):
    """multi_tensor.py:528-533: lr * ||p|| / ||u|| where both norms are
    nonzero, when NVLAMB or weight decay is on; else lr."""
    if use_nvlamb or weight_decay != 0.0:
        return torch.where((un != 0.0) & (pn != 0.0), lr * (pn / un),
                           torch.full_like(pn, lr))
    return torch.full_like(pn, lr)


def lamb_step(g, p, m, v, table: SegmentTable, *, lr, beta1: float,
              beta2: float, eps: float, step, bias_correction: bool = True,
              weight_decay: float = 0.0, grad_averaging: bool = True,
              mode: int = MODE_L2, global_grad_norm,
              max_grad_norm: float = 0.0, use_nvlamb: bool = False):
    """Two-phase LAMB over a row-aligned flat buffer (multi_tensor.py:485-
    544): phase 1, the per-tensor norms as fixed-order sums over each
    segment's rows, the trust ratio, phase 2. Returns new (p, m, v)."""
    sc = lamb_scalars(beta1=beta1, beta2=beta2, eps=eps, step=step,
                      bias_correction=bias_correction,
                      weight_decay=weight_decay,
                      grad_averaging=grad_averaging,
                      global_grad_norm=global_grad_norm,
                      max_grad_norm=max_grad_norm, device=p.device)
    u, m_new, v_new, prow, urow = lamb_phase1(g, p, m, v, sc, mode)
    lengths = table.row_lengths(p.device)
    pn = torch.sqrt(segment_sum(prow, lengths))
    un = torch.sqrt(segment_sum(urow, lengths))
    ratio = _trust_ratio(pn, un, lr, use_nvlamb, weight_decay)
    p_new = lamb_phase2(p, u, ratio, table.row_segment_ids(p.device))
    return p_new, m_new, v_new


def lamb_step_plain(g, p, m, v, table: SegmentTable, **kw):
    """Plain version of the whole step (reference.py:329-384, aligned):
    the plain phases, as :func:`lamb_step` composes them."""
    with dispatch.backend("reference"):
        return lamb_step(g, p, m, v, table, **kw)


# -- Adam (K15) ---------------------------------------------------------------

def adam_scalars(*, lr: float, beta1: float, beta2: float, eps: float, step,
                 bias_correction: bool, weight_decay: float,
                 device) -> torch.Tensor:
    """The Adam kernel's scalars as one fp32 [9] device array:
    ``[lr, b1, b2, eps, bc1, bc2, wd, 1-b1, 1-b2]`` (multi_tensor.py:
    276-277). ``1-b1`` and ``1-b2`` are taken in float64, then rounded to
    fp32 (:272-275); ``bc1``, ``bc2`` come from the device step, so
    nothing waits for the host."""
    device = torch.device(device)
    const = _consts((lr, beta1, beta2, eps, weight_decay, 1.0 - beta1,
                     1.0 - beta2), device)
    if bias_correction:
        stepf = torch.as_tensor(step, device=device).to(torch.float32)
        bc = 1.0 - torch.pow(const[1:3], stepf)
    else:
        bc = torch.ones(2, dtype=torch.float32, device=device)
    return torch.cat([const[:4], bc, const[4:]])


def adam_plain(g, p, m, v, sc: torch.Tensor, mode: int):
    """Plain version of ``_adam_kernel`` (multi_tensor.py:270-291): new
    (p, m, v) in their storage dtype, fp32 math with one rounding per
    operation, in the kernel's order."""
    lr, b1, b2, eps, bc1, bc2, wd, omb1, omb2 = sc.unbind()
    gf = g.float()
    pf = p.float()
    if mode == MODE_L2:
        gf = gf + wd * pf
    mf = b1 * m.float() + omb1 * gf
    vf = b2 * v.float() + omb2 * gf * gf
    u = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
    if mode == MODE_DECOUPLED:
        u = u + wd * pf
    return (pf - lr * u).to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)


def adam(g, p, m, v, sc: torch.Tensor, mode: int):
    """Adam (mode 0, L2) or AdamW (mode 1) over flat buffers of a length
    that is a multiple of 4; returns new (p, m, v) like
    :func:`adam_plain`."""
    if not dispatch.use_kernel(p):
        return adam_plain(g, p, m, v, sc, mode)
    n = p.numel()
    if n % 4 or p.dim() != 1 or g.shape != p.shape or m.shape != p.shape \
            or v.shape != p.shape:
        raise ValueError("adam: g, p, m, v must be flat buffers of one "
                         "length, a multiple of 4")
    for what, t in (("g", g), ("p", p), ("m", m), ("v", v)):
        _check_flat(f"adam {what}", t, p.device)
    if m.dtype != p.dtype or v.dtype != p.dtype:
        raise TypeError("adam: p, m and v must share one dtype")
    if sc.dtype != torch.float32 or sc.numel() != 9 or sc.device != p.device:
        raise ValueError("adam: scalars must be fp32 [9] on the card")
    p_out, m_out, v_out = (torch.empty_like(t) for t in (p, m, v))
    sc = sc.contiguous()
    if n:
        err = _cuda.lib().apex_adam(
            _cuda.dtype_code(g.dtype, "adam g"),
            _cuda.dtype_code(p.dtype, "adam p"), g.data_ptr(), p.data_ptr(),
            m.data_ptr(), v.data_ptr(), p_out.data_ptr(), m_out.data_ptr(),
            v_out.data_ptr(), sc.data_ptr(), n, int(mode),
            _cuda.stream(p.device))
        _cuda.check(err, "adam")
        adam.launches += 1
    return p_out, m_out, v_out


adam.launches = 0


def adam_step(g, p, m, v, *, lr, beta1: float, beta2: float, eps: float,
              step, mode: int = MODE_L2, bias_correction: bool = True,
              weight_decay: float = 0.0):
    """Fused Adam/AdamW over the flat buffer (multi_tensor.py:294-319):
    the scalars, then one :func:`adam` pass. Returns new (p, m, v)."""
    sc = adam_scalars(lr=lr, beta1=beta1, beta2=beta2, eps=eps, step=step,
                      bias_correction=bias_correction,
                      weight_decay=weight_decay, device=p.device)
    return adam(g, p, m, v, sc, mode)


# -- per-row norms (K13, K14) and the per-tensor norms ------------------------

def _check_rows(what: str, x: torch.Tensor) -> None:
    if x.dim() != 1 or x.numel() % LANES:
        raise ValueError(f"{what}: x must be a flat buffer of a multiple of "
                         f"{LANES} elements")
    _check_flat(what, x, x.device)


def rowsumsq_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``_rowsumsq_kernel`` (multi_tensor.py:197-199):
    fp32 sum of x² over each 128-element row."""
    xf = x.float()
    return (xf * xf).view(-1, LANES).sum(dim=1)


def rowsumsq(x: torch.Tensor) -> torch.Tensor:
    """fp32 [rows]: Σx² of each row of x [rows * 128] (fp32 or bf16)."""
    if not dispatch.use_kernel(x):
        return rowsumsq_plain(x)
    _check_rows("rowsumsq", x)
    out = torch.empty(x.numel() // LANES, dtype=torch.float32,
                      device=x.device)
    if out.numel():
        err = _cuda.lib().apex_rowsumsq(
            _cuda.dtype_code(x.dtype, "rowsumsq"), x.data_ptr(),
            out.data_ptr(), out.numel(), _cuda.stream(x.device))
        _cuda.check(err, "rowsumsq")
        rowsumsq.launches += 1
    return out


rowsumsq.launches = 0


def rowmaxabs_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``_rowmaxabs_kernel`` (multi_tensor.py:219-221):
    max |x| of each 128-element row, fp32 (NaN wins, as in ``amax``)."""
    return x.float().abs().view(-1, LANES).amax(dim=1)


def rowmaxabs(x: torch.Tensor) -> torch.Tensor:
    """fp32 [rows]: max |x| of each row of x [rows * 128]; exact, so equal
    to :func:`rowmaxabs_plain` bit for bit."""
    if not dispatch.use_kernel(x):
        return rowmaxabs_plain(x)
    _check_rows("rowmaxabs", x)
    out = torch.empty(x.numel() // LANES, dtype=torch.float32,
                      device=x.device)
    if out.numel():
        err = _cuda.lib().apex_rowmaxabs(
            _cuda.dtype_code(x.dtype, "rowmaxabs"), x.data_ptr(),
            out.data_ptr(), out.numel(), _cuda.stream(x.device))
        _cuda.check(err, "rowmaxabs")
        rowmaxabs.launches += 1
    return out


rowmaxabs.launches = 0


def segment_max(vals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Max of each segment of contiguous non-negative ``vals``; an empty
    segment gives 0, the identity of |x| (reference.py:155-168), where
    ``segment_reduce`` alone would give -inf."""
    return torch.segment_reduce(vals, "max", lengths=lengths, initial=0.0)


def l2norm_per_segment(x: torch.Tensor, table: SegmentTable) -> torch.Tensor:
    """Per-tensor L2 norms of a row-aligned flat buffer
    (multi_tensor.py:246-257): the row pass, then a fixed-order sum over
    each segment's rows."""
    return torch.sqrt(segment_sum(rowsumsq(x), table.row_lengths(x.device)))


def maxnorm_per_segment(x: torch.Tensor, table: SegmentTable) -> torch.Tensor:
    """Per-tensor L-inf norms of a row-aligned flat buffer
    (multi_tensor.py:260-263): the row pass, then a max over each
    segment's rows."""
    return segment_max(rowmaxabs(x), table.row_lengths(x.device))


def norm_out_blend(old, new, alpha: float, beta: float, norm_type: int):
    """reference.py:171-178: L2 ``sqrt(a·old² + b·new²)``, L-inf
    ``a·old + b·new``; NovoGrad's per-tensor second moment."""
    if norm_type == NORM_LINF:
        return alpha * old + beta * new
    return torch.sqrt(alpha * torch.square(old) + beta * torch.square(new))


# -- SGD (K17) ----------------------------------------------------------------

SGD_MOMENTUM, SGD_NESTEROV, SGD_WD_AFTER, SGD_WD = 1, 2, 4, 8   # flag bits


def sgd_scalars(*, wd: float, lr: float, momentum: float, dampening: float,
                first_run, scale=1.0, device) -> torch.Tensor:
    """The SGD kernel's scalars as one fp32 [6] device array:
    ``[wd, lr, momentum, 1-dampening, scale, first_run]``; ``1-dampening``
    in float64, then rounded to fp32, as the JAX kernel takes it
    (multi_tensor.py:363); ``first_run`` (a device bool, step == 1) and
    ``scale`` may be device values, so nothing waits for the host."""
    device = torch.device(device)
    const = _consts((wd, lr, momentum, 1.0 - dampening), device)
    tail = [torch.as_tensor(v, device=device).to(torch.float32).reshape(())
            for v in (scale, first_run)]
    return torch.cat([const, torch.stack(tail)])


def _sgd_flags(*, wd: float, momentum: float, nesterov: bool,
               wd_after_momentum: bool) -> int:
    # weight decay is skipped when wd == 0, as reference.py:246 does (the
    # Pallas kernel adds 0·p, which differs only where p is not finite)
    return ((SGD_MOMENTUM if momentum != 0.0 else 0)
            | (SGD_NESTEROV if nesterov else 0)
            | (SGD_WD_AFTER if wd_after_momentum else 0)
            | (SGD_WD if wd != 0.0 else 0))


def sgd_plain(g, p, m, sc: torch.Tensor, flags: int):
    """Plain version of ``_sgd_kernel`` (multi_tensor.py:354-369, in
    reference.py:232-258's form): new (p, momentum) in their storage
    dtype, fp32 math with one rounding per operation, in the kernel's
    order."""
    wd, lr, mom, omd, scl, first = sc.unbind()
    gf = g.float() * scl
    pf = p.float()
    mf = m.float()
    if flags & SGD_WD and not flags & SGD_WD_AFTER:
        gf = gf + wd * pf
    if flags & SGD_MOMENTUM:
        mf = torch.where(first > 0.0, gf, mf * mom + omd * gf)
        gf = gf + mom * mf if flags & SGD_NESTEROV else mf
    if flags & SGD_WD and flags & SGD_WD_AFTER:
        gf = gf + wd * pf
    return (pf - lr * gf).to(p.dtype), mf.to(m.dtype)


def sgd(g, p, m, sc: torch.Tensor, flags: int):
    """SGD over flat buffers of a length that is a multiple of 4; returns
    new (p, momentum) like :func:`sgd_plain`."""
    if not dispatch.use_kernel(p):
        return sgd_plain(g, p, m, sc, flags)
    n = p.numel()
    if n % 4 or p.dim() != 1 or g.shape != p.shape or m.shape != p.shape:
        raise ValueError("sgd: g, p, m must be flat buffers of one length, "
                         "a multiple of 4")
    for what, t in (("g", g), ("p", p), ("m", m)):
        _check_flat(f"sgd {what}", t, p.device)
    if m.dtype != p.dtype:
        raise TypeError("sgd: p and m must share one dtype")
    if sc.dtype != torch.float32 or sc.numel() != 6 or sc.device != p.device:
        raise ValueError("sgd: scalars must be fp32 [6] on the card")
    p_out, m_out = torch.empty_like(p), torch.empty_like(m)
    sc = sc.contiguous()
    if n:
        err = _cuda.lib().apex_sgd(
            _cuda.dtype_code(g.dtype, "sgd g"),
            _cuda.dtype_code(p.dtype, "sgd p"), g.data_ptr(), p.data_ptr(),
            m.data_ptr(), p_out.data_ptr(), m_out.data_ptr(), sc.data_ptr(),
            n, int(flags), _cuda.stream(p.device))
        _cuda.check(err, "sgd")
        sgd.launches += 1
    return p_out, m_out


sgd.launches = 0


def sgd_step(g, p, mom, *, wd: float, momentum: float, dampening: float,
             lr, nesterov: bool = False, first_run=False,
             wd_after_momentum: bool = False, scale=1.0):
    """Fused SGD with momentum, dampening and nesterov over the flat
    buffer (multi_tensor.py:372-390); ``first_run`` sets the momentum to
    the incoming grad. Returns new (p, momentum)."""
    sc = sgd_scalars(wd=wd, lr=lr, momentum=momentum, dampening=dampening,
                     first_run=first_run, scale=scale, device=p.device)
    flags = _sgd_flags(wd=wd, momentum=momentum, nesterov=nesterov,
                       wd_after_momentum=wd_after_momentum)
    return sgd(g, p, mom, sc, flags)


# -- NovoGrad (K18) -----------------------------------------------------------

def novograd_scalars(*, lr: float, beta1: float, weight_decay: float,
                     grad_averaging: bool, bc1, device) -> torch.Tensor:
    """The NovoGrad kernel's scalars as one fp32 [5] device array:
    ``[lr, b1, wd, beta3, bc1]``; ``beta3 = 1-b1`` in float64, then
    rounded (multi_tensor.py:395); ``bc1`` from the device step."""
    device = torch.device(device)
    beta3 = (1.0 - beta1) if grad_averaging else 1.0
    const = _consts((lr, beta1, weight_decay, beta3), device)
    return torch.cat([const, torch.as_tensor(bc1, device=device).to(
        torch.float32).reshape(1)])


def novograd_plain(g, p, m, denom, row_seg, sc: torch.Tensor, mode: int):
    """Plain version of ``_novograd_kernel`` (multi_tensor.py:393-410,
    reference.py:318-325): new (p, m) in their storage dtype; each row
    reads ``denom`` [segments] through its segment id."""
    lr, b1, wd, beta3, bc1 = sc.unbind()
    d = denom[row_seg.long()][:, None]
    gf = g.float().view(-1, LANES)
    pf = p.float().view(-1, LANES)
    mf = m.float().view(-1, LANES)
    if mode == MODE_L2:
        gf = gf / d + wd * pf
        mf = b1 * mf + beta3 * gf
        pf = pf - lr * (mf / bc1)
    else:
        mf = b1 * mf + beta3 * gf
        pf = pf - lr * ((mf / bc1) / d + wd * pf)
    return pf.view(-1).to(p.dtype), mf.view(-1).to(m.dtype)


def novograd(g, p, m, denom, row_seg, sc: torch.Tensor, mode: int):
    """NovoGrad's elementwise update over flat buffers of ``rows * 128``
    elements: g (fp32 or bf16), p and m in one dtype, denom fp32
    [segments], row_seg int32 [rows]. Returns new (p, m)."""
    if not dispatch.use_kernel(p):
        return novograd_plain(g, p, m, denom, row_seg, sc, mode)
    n = p.numel()
    if n % LANES or p.dim() != 1 or g.shape != p.shape or m.shape != p.shape:
        raise ValueError(f"novograd: g, p, m must be flat buffers of one "
                         f"length, a multiple of {LANES}")
    for what, t in (("g", g), ("p", p), ("m", m)):
        _check_flat(f"novograd {what}", t, p.device)
    if m.dtype != p.dtype:
        raise TypeError("novograd: p and m must share one dtype")
    if denom.dtype != torch.float32 or row_seg.dtype != torch.int32 \
            or row_seg.numel() != n // LANES:
        raise ValueError("novograd: denom must be float32 [segments] and "
                         "row_seg int32 [rows]")
    for t in (denom, row_seg):
        if t.device != p.device or not t.is_contiguous():
            raise ValueError("novograd: denom and row_seg must be "
                             "contiguous on p's device")
    if sc.dtype != torch.float32 or sc.numel() != 5 or sc.device != p.device:
        raise ValueError("novograd: scalars must be fp32 [5] on the card")
    if mode not in (MODE_L2, MODE_DECOUPLED):
        raise ValueError(f"novograd: mode must be 0 or 1, got {mode}")
    p_out, m_out = torch.empty_like(p), torch.empty_like(m)
    sc = sc.contiguous()
    if n:
        err = _cuda.lib().apex_novograd(
            _cuda.dtype_code(g.dtype, "novograd g"),
            _cuda.dtype_code(p.dtype, "novograd p"), g.data_ptr(),
            p.data_ptr(), m.data_ptr(), denom.data_ptr(), row_seg.data_ptr(),
            p_out.data_ptr(), m_out.data_ptr(), sc.data_ptr(), n // LANES,
            int(mode), _cuda.stream(p.device))
        _cuda.check(err, "novograd")
        novograd.launches += 1
    return p_out, m_out


novograd.launches = 0


def novograd_step(g, p, m, v_norms, table: SegmentTable, *, lr,
                  beta1: float, beta2: float, eps: float, step,
                  bias_correction: bool = True, weight_decay: float = 0.0,
                  grad_averaging: bool = True, mode: int = MODE_L2,
                  norm_type: int = NORM_L2, grad_norms=None):
    """Fused NovoGrad over a row-aligned flat buffer (multi_tensor.py:
    413-449, reference.py:282-326): the per-tensor norms of g (or
    ``grad_norms``, when the caller has taken them), their blend into
    ``v_norms`` [segments], the bias corrections and ``denom = v/bc2 +
    eps`` plain on the device, then one :func:`novograd` pass. Returns
    new (p, m, v_norms)."""
    device = p.device
    if grad_norms is None:
        per_segment = maxnorm_per_segment if norm_type == NORM_LINF \
            else l2norm_per_segment
        grad_norms = per_segment(g, table)
    v_new = norm_out_blend(v_norms, grad_norms, beta2, 1.0 - beta2,
                           norm_type)
    if bias_correction:
        betas = _consts((beta1, beta2), device)
        stepf = torch.as_tensor(step, device=device).to(torch.float32)
        bc1 = 1.0 - torch.pow(betas[0], stepf)
        bc2 = torch.sqrt(1.0 - torch.pow(betas[1], stepf))
        denom = v_new / bc2 + eps
    else:
        bc1 = 1.0
        denom = v_new + eps
    sc = novograd_scalars(lr=lr, beta1=beta1, weight_decay=weight_decay,
                          grad_averaging=grad_averaging, bc1=bc1,
                          device=device)
    p_new, m_new = novograd(g, p, m, denom.contiguous(),
                            table.row_segment_ids(device), sc, mode)
    return p_new, m_new, v_new


# -- axpby (K11) --------------------------------------------------------------

def _axpby_scalars(a, b, device) -> torch.Tensor:
    """``[a, b]`` as one fp32 [2] device array; a device scalar (the
    unscale factor) stays on the device."""
    return torch.cat([_as_device_scalar(a, device),
                      _as_device_scalar(b, device)])


def axpby_plain(a, x: torch.Tensor, b, y: torch.Tensor,
                arg_to_check: int = -1):
    """Plain version (reference.py:70-90): fp32 ``a·x + b·y`` in x's dtype
    (each product rounded, then the sum), and a device bool that is True
    when an input it checks is not finite: x for ``arg_to_check`` 0, y for
    1, both otherwise."""
    sa, sb = _axpby_scalars(a, b, x.device).unbind()
    xf, yf = x.float(), y.float()
    out = (sa * xf + sb * yf).to(x.dtype)
    if arg_to_check == 0:
        bad = ~torch.isfinite(xf).all()
    elif arg_to_check == 1:
        bad = ~torch.isfinite(yf).all()
    else:
        bad = ~(torch.isfinite(xf).all() & torch.isfinite(yf).all())
    return out, bad


def axpby(a, x: torch.Tensor, b, y: torch.Tensor, arg_to_check: int = -1):
    """``(a·x + b·y, found_inf)`` over flat buffers of one length (fp32 or
    bf16 each; out in x's dtype); ``a`` and ``b`` are floats or
    one-element fp32 tensors on x's device, so ``1/scale`` is never read
    back. Equal to :func:`axpby_plain` bit for bit."""
    if not dispatch.use_kernel(x):
        return axpby_plain(a, x, b, y, arg_to_check)
    if x.dim() != 1 or y.shape != x.shape:
        raise ValueError("axpby: x and y must be flat buffers of one length")
    _check_flat("axpby x", x, x.device, align_elems=1)
    _check_flat("axpby y", y, x.device, align_elems=1)
    sc = _axpby_scalars(a, b, x.device)
    out = torch.empty_like(x)
    flag = torch.zeros(1, dtype=torch.int32, device=x.device)
    if x.numel():
        check = arg_to_check if arg_to_check in (0, 1) else -1
        err = _cuda.lib().apex_axpby(
            _cuda.dtype_code(x.dtype, "axpby x"),
            _cuda.dtype_code(y.dtype, "axpby y"), x.data_ptr(), y.data_ptr(),
            out.data_ptr(), sc.data_ptr(), flag.data_ptr(), x.numel(),
            check, _cuda.stream(x.device))
        _cuda.check(err, "axpby")
        axpby.launches += 1
    return out, flag[0] != 0


axpby.launches = 0


# -- global L2 norm (K12) -----------------------------------------------------

# stage 1's blocks at most, each writing one fp32 partial sum; a fixed grid
# for a given length, so the sum's order, and the norm's bits, repeat
_NORM_PARTIALS = 132 * 8


def l2norm_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version (reference.py:97-100): ``sqrt(sum(x²))`` in fp32."""
    xf = x.float()
    return torch.sqrt(torch.sum(xf * xf))


def l2norm(x: torch.Tensor) -> torch.Tensor:
    """The global L2 norm of a flat buffer (fp32 or bf16, any length) as
    a 0-d fp32 device tensor; two calls on the same input are bit-equal."""
    if not dispatch.use_kernel(x):
        return l2norm_plain(x)
    if x.dim() != 1:
        raise ValueError("l2norm: x must be a flat 1-D buffer")
    _check_flat("l2norm", x, x.device, align_elems=1)
    out = torch.zeros(1, dtype=torch.float32, device=x.device)
    if x.numel():
        partial = torch.empty(_NORM_PARTIALS, dtype=torch.float32,
                              device=x.device)
        err = _cuda.lib().apex_l2norm(
            _cuda.dtype_code(x.dtype, "l2norm"), x.data_ptr(),
            partial.data_ptr(), out.data_ptr(), x.numel(), _NORM_PARTIALS,
            _cuda.stream(x.device))
        _cuda.check(err, "l2norm")
        l2norm.launches += 1
    return out[0]


l2norm.launches = 0


# -- Adagrad (K16) ------------------------------------------------------------

def adagrad_scalars(*, lr: float, eps: float, weight_decay: float,
                    device) -> torch.Tensor:
    """The Adagrad kernel's scalars as one fp32 [3] device array:
    ``[lr, eps, wd]`` (multi_tensor.py:323)."""
    return _consts((lr, eps, weight_decay), torch.device(device))


def adagrad_plain(g, p, h, sc: torch.Tensor, mode: int):
    """Plain version of ``_adagrad_kernel`` (multi_tensor.py:322-336,
    reference.py:216-230): new (p, h) in their storage dtype, fp32 math
    with one rounding per operation, in the kernel's order; ``wd·p`` is
    added at wd 0 too."""
    lr, eps, wd = sc.unbind()
    gf, pf, hf = g.float(), p.float(), h.float()
    if mode == MODE_L2:
        gf = gf + wd * pf
        hf = hf + gf * gf
        pf = pf - lr * (gf / (torch.sqrt(hf) + eps))
    else:
        hf = hf + gf * gf
        pf = pf - lr * (gf / (torch.sqrt(hf) + eps) + wd * pf)
    return pf.to(p.dtype), hf.to(h.dtype)


def adagrad(g, p, h, sc: torch.Tensor, mode: int):
    """Adagrad (mode 0, L2 weight decay; mode 1, decoupled) over flat
    buffers of a length that is a multiple of 4; returns new (p, h) like
    :func:`adagrad_plain`, bit for bit."""
    if not dispatch.use_kernel(p):
        return adagrad_plain(g, p, h, sc, mode)
    n = p.numel()
    if n % 4 or p.dim() != 1 or g.shape != p.shape or h.shape != p.shape:
        raise ValueError("adagrad: g, p, h must be flat buffers of one "
                         "length, a multiple of 4")
    for what, t in (("g", g), ("p", p), ("h", h)):
        _check_flat(f"adagrad {what}", t, p.device)
    if h.dtype != p.dtype:
        raise TypeError("adagrad: p and h must share one dtype")
    if sc.dtype != torch.float32 or sc.numel() != 3 or sc.device != p.device:
        raise ValueError("adagrad: scalars must be fp32 [3] on the card")
    if mode not in (MODE_L2, MODE_DECOUPLED):
        raise ValueError(f"adagrad: mode must be 0 or 1, got {mode}")
    p_out, h_out = torch.empty_like(p), torch.empty_like(h)
    sc = sc.contiguous()
    if n:
        err = _cuda.lib().apex_adagrad(
            _cuda.dtype_code(g.dtype, "adagrad g"),
            _cuda.dtype_code(p.dtype, "adagrad p"), g.data_ptr(),
            p.data_ptr(), h.data_ptr(), p_out.data_ptr(), h_out.data_ptr(),
            sc.data_ptr(), n, int(mode), _cuda.stream(p.device))
        _cuda.check(err, "adagrad")
        adagrad.launches += 1
    return p_out, h_out


adagrad.launches = 0


def adagrad_step(g, p, h, *, lr, eps: float, mode: int = MODE_L2,
                 weight_decay: float = 0.0):
    """Fused Adagrad over the flat buffer (multi_tensor.py:339-351): the
    scalars, then one :func:`adagrad` pass. Returns new (p, h)."""
    sc = adagrad_scalars(lr=lr, eps=eps, weight_decay=weight_decay,
                         device=p.device)
    return adagrad(g, p, h, sc, mode)
