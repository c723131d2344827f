"""The training steps of the JAX package's two benches and its ImageNet
example.

``Trainer`` is the ResNet AMP step: with its default FusedLAMB, the
counterpart of ``bench.py``'s ``_loss_fn`` and ``train_step``
(bench.py:1244-1306); with ``optimizer="sgd"`` (FusedSGD, lr 0.1,
momentum 0.9, weight decay 1e-4) and a uint8 NHWC batch normalized inside
the step, ``examples/imagenet/main_amp.py``'s training step
(:239-288), and ``evaluate`` its validation step (:401-414); with a
``models.ViT`` (``--arch vit_b16 --dropout 0.1``), the same step on the
model without BN state, its attention dropout seeded per step and layer
(:178-186, :490-497).
``DCGANTrainer`` is ``examples/dcgan/main_amp.py``'s step (:151-207): two
models, two FusedAdams and three loss scalers, O1 by default.
``LMTrainer`` is the FusedAdam step of ``tools/lm_bench.py`` (:255-272,
one device) for the decoder LM and, with the batch and loss keywords
passed through, of ``examples/seq2seq/train_translation.py`` for the
Seq2Seq Transformer; with ``microbatches`` or a ``loss_scale``, the
gradient accumulation of ``examples/lm/train_ring.py``. Both
differentiate with respect to the flat fp32 master buffer
(``master_grad``).

The ResNet step, as the JAX bench runs it:

1. the flat fp32 master buffer becomes the model's params in one cast
   (``ops.flat.unflatten(master, table, dtype=half)``);
2. the ResNet forward and backward, BN through the ``SyncBatchNorm``
   training core, the loss an fp32 log-softmax, ``select_label_logits``
   and a mean, scaled by the loss scale; the gradient is taken with
   respect to the flat master, so it comes back as one flat fp32 buffer;
3. the loss scaler's unscale (the ``scale`` kernel) and overflow flag;
4. the optimizer's update — FusedLAMB's two phases (the LAMB kernels),
   FusedSGD (the SGD kernel), FusedNovoGrad (the per-row norm and
   NovoGrad kernels), any of them under LARC (the per-row norm kernel) —
   skipped branchlessly on overflow, and the scaler's update.

Nothing in the step reads a value back to the host: the loss is returned
as a device tensor.
"""

from __future__ import annotations

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.amp import frontend as _amp
from apex_tpu_torch.amp.autocast import autocast
from apex_tpu_torch.contrib.xentropy import select_label_logits
from apex_tpu_torch.data import normalize_imagenet
from apex_tpu_torch.models.dcgan import bce_logits
from apex_tpu_torch.models.vit import ViT
from apex_tpu_torch.ops import flat as _flat
from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGrad
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD
from apex_tpu_torch.optimizers.larc import LARC

__all__ = ["master_grad", "Trainer", "LMTrainer", "DCGANTrainer"]


def master_grad(master, table, dtype, objective):
    """The O2 master-weight pattern: ``objective`` sees the params as one
    cast of the flat master (``unflatten(master, table, dtype=dtype)``)
    and returns ``(value, aux)``; the gradient of ``value`` comes back
    with respect to the flat master, one fp32 buffer. Returns
    ``(flat grad, aux)``."""
    m = master.detach().requires_grad_(True)
    value, aux = objective(_flat.unflatten(m, table, dtype=dtype))
    (grad,) = torch.autograd.grad(value, m)
    return grad, aux


# Trainer's optimizers, each with its source's defaults: bench.py's
# FusedLAMB(lr=1e-3), main_amp.py's FusedSGD (:53-62, :208-210) and the
# class defaults of FusedNovoGrad
OPTIMIZERS = {"lamb": (FusedLAMB, {"lr": 1e-3}),
              "sgd": (FusedSGD, {"lr": 0.1, "momentum": 0.9,
                                 "weight_decay": 1e-4}),
              "novograd": (FusedNovoGrad, {})}


class Trainer:
    """Owns the model, its BN state, the AMP handle and its state, and the
    optimizer with its state (in ``opt.state``).

    ``params`` and ``bn_state`` are the model's trees (``model.init()`` or
    ``convert.resnet_from_jax``); ``opt_level`` and ``amp_overrides`` go
    to ``amp.initialize`` (O2 on bf16 means a static loss scale of 1.0).
    At O1 the step is main_amp's at ``--opt-level O1`` (:182-187,
    :206, :242-252): the policy casts no model, so the params and the
    normalized batch stay fp32, and main_amp applies its model without
    ``amp.autocast``, so this step does too; the loss scale is the O1
    preset's (dynamic for fp16, 1.0 for bf16). ``optimizer`` is ``"lamb"`` (bench.py's step, the
    default), ``"sgd"`` or ``"novograd"``, with the defaults of
    ``OPTIMIZERS``; ``lr``, ``weight_decay``, ``momentum`` (SGD) and
    ``norm_type`` (NovoGrad), main_amp's flags and NovoGrad's norm, go
    to the class where given, and ``larc=True`` wraps it in ``LARC`` with
    LARC's defaults. Everything lives on ``device``, the card unless
    ``device="cpu"``.

    A ``ViT`` model has no BN state (``bn_state`` stays None, as
    main_amp's ``apply_model`` keeps ``{}``) and takes its batch
    channels-last. With ``dropout`` > 0 each training step draws one
    dropout seed per layer from ``generator`` (a ``torch.Generator``;
    seeded 17 when not given, as main_amp's dropout base key is
    ``jax.random.key(17)``, :476), or takes the ``dropout_seeds`` given to
    ``step``; ``evaluate`` runs without dropout.
    """

    def __init__(self, model, params, bn_state=None, *,
                 opt_level: str = "O2", optimizer: str = "lamb", lr=None,
                 momentum=None, weight_decay=None, norm_type=None,
                 larc: bool = False, generator=None, device=None,
                 **amp_overrides):
        self.device = resolve_device(device)
        self.model = model
        _, self.handle = _amp.initialize(opt_level=opt_level, verbosity=0,
                                         **amp_overrides)
        # main_amp's ``cast_model_dtype or float32`` (:206)
        self.half = self.handle.policy.cast_model_dtype or torch.float32
        self.amp_state = self.handle.init_state(self.device)
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer must be one of {sorted(OPTIMIZERS)}"
                             f", got {optimizer!r}")
        cls, kw = OPTIMIZERS[optimizer]
        given = dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
                     norm_type=norm_type)
        kw = {**kw, **{k: v for k, v in given.items() if v is not None}}
        base = cls(params, device=self.device, **kw)
        self.table = base._tables[0]
        self.opt = LARC(base) if larc else base
        self.is_vit = isinstance(model, ViT)
        self.bn_state = {} if bn_state is None else _flat.tree_map(
            lambda t: t.to(self.device), bn_state)
        self.generator = generator if generator is not None else \
            torch.Generator().manual_seed(17)

    def _input(self, x):
        """The model's input: a float batch (N, 3, H, W) cast to the half
        dtype, or a uint8 batch (N, H, W, 3) normalized on the device in
        it, then seen as NCHW (channels_last), as main_amp.py:243-245; a
        ViT keeps the batch channels-last."""
        if x.dtype == torch.uint8:
            x = normalize_imagenet(x, dtype=self.half)
            return x if self.is_vit else x.permute(0, 3, 1, 2)
        return x.to(self.half) if x.is_floating_point() else x

    def _apply(self, params, x, training: bool, dropout_seeds=None):
        """``(logits, new BN state)`` for either family (main_amp.py's
        ``apply_model``, :178-186)."""
        if self.is_vit:
            return self.model.apply(params, x, is_training=training,
                                    dropout_seeds=dropout_seeds), \
                self.bn_state
        return self.model.apply(params, self.bn_state, x, training=training)

    def draw_dropout_seeds(self):
        """One step's per-layer dropout seeds from ``generator``, or None
        for a model without dropout."""
        if not (self.is_vit and self.model.dropout > 0.0):
            return None
        return torch.randint(-(1 << 31), 1 << 31, (self.model.num_layers,),
                             generator=self.generator).tolist()

    def loss_and_grad(self, x, y, dropout_seeds=None):
        """Forward and backward: ``(flat fp32 master grad, still scaled;
        loss; new BN state)``. ``dropout_seeds`` (a ViT's, one per layer)
        are drawn from ``generator`` when not given."""
        x = self._input(x)
        if dropout_seeds is None:
            dropout_seeds = self.draw_dropout_seeds()

        def objective(p_half):
            logits, new_bn = self._apply(p_half, x, True, dropout_seeds)
            logp = torch.log_softmax(logits.float(), dim=-1)
            loss = -torch.mean(select_label_logits(logp, y))
            return (self.handle.scale_loss(loss, self.amp_state),
                    (loss.detach(), new_bn))

        flat_grad, (loss, new_bn) = master_grad(
            self.opt.state[0].master, self.table, self.half, objective)
        return flat_grad, loss, new_bn

    def apply_grads(self, flat_grad, new_bn):
        """Unscale, update the masters (skipped on overflow) and the
        scaler; keep the new BN state. Returns found_inf (device bool)."""
        flat_grad, found_inf = self.handle.unscale(flat_grad,
                                                   self.amp_state)
        self.opt.state = self.opt.apply_update(
            self.opt.state, [flat_grad], found_inf=found_inf)
        self.amp_state = self.handle.update(self.amp_state, found_inf)
        self.bn_state = new_bn
        return found_inf

    def step(self, x, y, dropout_seeds=None):
        """One training step on ``x`` (float (N, 3, H, W) or uint8
        (N, H, W, 3); a ViT's float batch channels-last) and int labels
        ``y``; returns the unscaled loss as a device tensor."""
        flat_grad, loss, new_bn = self.loss_and_grad(x, y, dropout_seeds)
        self.apply_grads(flat_grad, new_bn)
        return loss

    @torch.no_grad()
    def evaluate(self, x, y):
        """main_amp.py's validation step (:401-414): the current masters
        in the half dtype, BN in eval mode on the running statistics;
        returns ``(top-1, top-5)`` accuracy as device tensors (top-k with
        k = min(5, classes))."""
        params = _flat.unflatten(self.opt.state[0].master, self.table,
                                 dtype=self.half)
        logits, _ = self._apply(params, self._input(x), False)
        k = min(5, logits.shape[-1])
        hit = torch.topk(logits.float(), k, dim=-1).indices == \
            y.to(torch.int64)[:, None]
        return hit[:, 0].float().mean(), hit.any(dim=-1).float().mean()


class LMTrainer:
    """The single-device FusedAdam step of ``tools/lm_bench.py``
    (:255-272) and ``examples/seq2seq/train_translation.py`` (:120-128):
    the flat fp32 master becomes the model's params in one cast to
    ``dtype`` (bf16, the O2 pattern; ``None`` keeps fp32, lm_bench's
    ``--dtype f32``), ``model.loss(params, *batch, **loss_kw)`` runs
    forward and backward, and ``FusedAdam(lr, betas, eps)`` with its other
    defaults (AdamW mode, weight decay 0) updates the masters. There is no
    loss scaler, as in both sources. Everything lives on ``device``, the
    card unless ``device="cpu"``; ``opt.state`` holds the masters, slots
    and step.

    With ``microbatches`` above 1 or a ``loss_scale`` (``"dynamic"`` or a
    number), the step is ``examples/lm/train_ring.py``'s (:137-143,
    ``--grad-accum``, ``--loss-scale``): ``amp.initialize(opt_level="O2",
    loss_scale=...)`` gives the handle, ``handle.accumulate_grads`` takes
    the batch split along dim 0 into ``microbatches`` equal parts, then
    the optimizer's update (skipped on an overflow) and the scaler's.
    """

    def __init__(self, model, params, *, lr: float = 1e-4,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 dtype=torch.bfloat16, microbatches: int = 1,
                 loss_scale=None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.dtype = dtype
        self.opt = FusedAdam(params, lr=lr, betas=betas, eps=eps,
                             device=self.device)
        self.table = self.opt._tables[0]
        if microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, got "
                             f"{microbatches}")
        self.microbatches = int(microbatches)
        self.handle = self.amp_state = None
        if self.microbatches > 1 or loss_scale is not None:
            # the policy's half dtype is the model's (bf16 unless fp16)
            half = dtype if dtype == torch.float16 else torch.bfloat16
            _, self.handle = _amp.initialize(opt_level="O2",
                                             half_dtype=half,
                                             loss_scale=loss_scale,
                                             verbosity=0)
            self.amp_state = self.handle.init_state(self.device)

    def loss_and_grad(self, *batch, **loss_kw):
        """``(flat fp32 master grad, loss)`` for the batch ``model.loss``
        takes after the params (the LM: tokens int [B, T + 1]; the
        Seq2Seq Transformer: source and target tokens), with ``loss_kw``
        passed on (``label_smoothing``)."""
        batch = [t.to(self.device) for t in batch]

        def objective(params):
            loss = self.model.loss(params, *batch, **loss_kw)
            return loss, loss.detach()

        return master_grad(self.opt.state[0].master, self.table, self.dtype,
                           objective)

    def accumulate_grads(self, *batch, **loss_kw):
        """train_ring's accumulation: ``(flat fp32 master grad, found_inf,
        mean loss)`` from ``handle.accumulate_grads`` over the batch split
        along dim 0 into ``microbatches`` parts, the grad unscaled and
        averaged, found_inf an fp32 device flag."""
        if self.handle is None:
            raise ValueError("accumulate_grads needs microbatches > 1 or a "
                             "loss_scale")
        n = self.microbatches
        for t in batch:
            if t.shape[0] % n:
                raise ValueError(f"batch of {t.shape[0]} does not split "
                                 f"into {n} microbatches")
        micro = tuple(t.to(self.device).reshape(n, t.shape[0] // n,
                                                *t.shape[1:])
                      for t in batch)

        def loss_fn(m, mb):
            params = _flat.unflatten(m, self.table, dtype=self.dtype)
            return self.model.loss(params, *mb, **loss_kw)

        return self.handle.accumulate_grads(
            loss_fn, self.opt.state[0].master, micro, self.amp_state)

    def apply_grads(self, grad, found_inf=None):
        """Update the masters from the flat grad (skipped where
        ``found_inf`` is set) and, with a handle, the scaler."""
        self.opt.state = self.opt.apply_update(self.opt.state, [grad],
                                               found_inf=found_inf)
        if self.handle is not None:
            self.amp_state = self.handle.update(self.amp_state, found_inf)

    def step(self, *batch, **loss_kw):
        """One training step; returns the loss as a device tensor (nothing
        is read back to the host)."""
        if self.handle is None:
            grad, loss = self.loss_and_grad(*batch, **loss_kw)
            self.apply_grads(grad)
        else:
            grad, found_inf, loss = self.accumulate_grads(*batch, **loss_kw)
            self.apply_grads(grad, found_inf)
        return loss


class DCGANTrainer:
    """``examples/dcgan/main_amp.py``'s step (:151-207) on ``model`` (a
    ``models.DCGAN``) from G's and D's parameter trees.

    ``amp.initialize(opt_level, num_losses=3)`` gives one handle with three
    scalers (``amp_overrides``, e.g. ``loss_scale="dynamic"``, go to it);
    two ``FusedAdam(lr, betas)`` hold G's and D's flat fp32 masters. Under
    O1 G and D run in ``amp.autocast`` (the policy's compute dtype, bf16 by
    default, as the example's ``amp.autocast(generator)``); at the other
    levels they run as given, on fp32 params, as the example does. A
    step, :meth:`step`:

    1. D's loss on the real batch (scaler 0) and on G's fakes (scaler 1,
       G's output held constant), each differentiated by itself with
       respect to D's flat master and unscaled by its own scaler (the
       ``scale`` kernel); D's update skipped on either overflow;
    2. G's loss through the same D (scaler 2), differentiated with respect
       to G's flat master, unscaled, G's update skipped on its overflow;
    3. each scaler updated on its own flag only, with the per-loss
       overflow census when ``numerics`` is set (:140-145, :190-203);
    4. the logged losses of :204-206, D's and G's, from the same forward
       passes (the values :204-206 recompute).

    Everything lives on ``device``, the card unless ``device="cpu"``;
    nothing is read back to the host.
    """

    def __init__(self, model, g_params, d_params, *, opt_level: str = "O1",
                 lr: float = 2e-4, betas=(0.5, 0.999),
                 numerics: bool = False, device=None, **amp_overrides):
        from apex_tpu_torch.prof import numerics as _nu
        self.device = resolve_device(device)
        self.model = model
        _, self.handle = _amp.initialize(opt_level=opt_level, num_losses=3,
                                         verbosity=0, **amp_overrides)
        self.amp_state = self.handle.init_state(self.device)
        self.g_opt = FusedAdam(g_params, lr=lr, betas=betas,
                               device=self.device)
        self.d_opt = FusedAdam(d_params, lr=lr, betas=betas,
                               device=self.device)
        self.g_table, self.d_table = self.g_opt._tables[0], \
            self.d_opt._tables[0]
        policy = self.handle.policy
        if policy.autocast:
            self.g_fwd = autocast(model.generator, policy.compute_dtype)
            self.d_fwd = autocast(model.discriminator, policy.compute_dtype)
        else:
            self.g_fwd, self.d_fwd = model.generator, model.discriminator
        self.censuses = None
        if numerics:
            self.d_meta = _nu.tree_meta(self.d_table)
            self.g_meta = _nu.tree_meta(self.g_table)
            self.censuses = tuple(
                _nu.empty_census(meta.n, device=self.device)
                for meta in (self.d_meta, self.d_meta, self.g_meta))

    def master_trees(self):
        """``(G's flat master, D's, G's tree, D's tree)``: fresh leaves of
        the masters that need a gradient, and the trees over them."""
        g_m = self.g_opt.state[0].master.detach().requires_grad_(True)
        d_m = self.d_opt.state[0].master.detach().requires_grad_(True)
        return (g_m, d_m, _flat.unflatten(g_m, self.g_table),
                _flat.unflatten(d_m, self.d_table))

    def loss_and_grads(self, real, z):
        """The three scaled losses' flat fp32 gradients, still scaled:
        ``((D real, D fake, G), (D's loss, G's loss))``. ``real``: images
        [B, 32, 32, 3] NHWC; ``z``: latents [B, nz]."""
        h, st = self.handle, self.amp_state
        g_m, d_m, gp, dp = self.master_trees()
        fake = self.g_fwd(gp, z)
        real_logits = self.d_fwd(dp, real)
        (fg_r,) = torch.autograd.grad(
            h.scale_loss(bce_logits(real_logits, 1.0), st, 0), d_m)
        # one D pass over the fakes serves D's fake loss (its gradient
        # with respect to D only: G's output held constant) and G's loss
        # (with respect to G only: D held constant)
        fake_logits = self.d_fwd(dp, fake)
        (fg_f,) = torch.autograd.grad(
            h.scale_loss(bce_logits(fake_logits, 0.0), st, 1), d_m,
            retain_graph=True)
        (fgg,) = torch.autograd.grad(
            h.scale_loss(bce_logits(fake_logits, 1.0), st, 2), g_m)
        with torch.no_grad():
            d_loss = bce_logits(real_logits, 1.0) + \
                bce_logits(fake_logits, 0.0)
            g_loss = bce_logits(fake_logits, 1.0)
        return (fg_r, fg_f, fgg), (d_loss, g_loss)

    def apply_grads(self, fg_r, fg_f, fgg):
        """Unscale each gradient by its own scaler, update D (skipped on
        either of its flags) and G (on its own), then each scaler on its
        own flag. Returns the three flags (device bools)."""
        h, st = self.handle, self.amp_state
        fg_r, inf0 = h.unscale(fg_r, st, loss_id=0)
        fg_f, inf1 = h.unscale(fg_f, st, loss_id=1)
        self.d_opt.state = self.d_opt.apply_update(
            self.d_opt.state, [fg_r + fg_f], found_inf=inf0 | inf1)
        fgg, inf2 = h.unscale(fgg, st, loss_id=2)
        self.g_opt.state = self.g_opt.apply_update(
            self.g_opt.state, [fgg], found_inf=inf2)
        flags = (inf0, inf1, inf2)
        if self.censuses is None:
            for i, fi in enumerate(flags):
                st = h.update(st, fi, loss_id=i)
        else:
            tables = (self.d_table, self.d_table, self.g_table)
            carried = []
            for i, (fi, g) in enumerate(zip(flags, (fg_r, fg_f, fgg))):
                st, c = h.update_with_census(st, fi, g, self.censuses[i],
                                             loss_id=i, table=tables[i])
                carried.append(c)
            self.censuses = tuple(carried)
        self.amp_state = st
        return flags

    def step(self, real, z):
        """One training step; returns D's and G's logged losses as device
        tensors."""
        grads, losses = self.loss_and_grads(real, z)
        self.apply_grads(*grads)
        return losses

    def g_underflow_census(self, z):
        """``--numerics``' end-of-run sample (main_amp.py:276-284): the
        underflow census of G's unscaled gradient, through D, on ``z``."""
        from apex_tpu_torch.prof import numerics as _nu
        g_m, _, gp, dp = self.master_trees()
        (fgg,) = torch.autograd.grad(
            bce_logits(self.d_fwd(dp, self.g_fwd(gp, z)), 1.0), g_m)
        return _nu.underflow_census(fgg, table=self.g_table)
