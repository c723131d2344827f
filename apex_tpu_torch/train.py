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
models, two FusedAdams and three loss scalers, O1 by default; its ``fit``
is the example's loop with the telemetry of ``--telemetry`` and ``--slo``
(:209-296).
``DDPTrainer`` and ``ZeROTrainer`` are the two distributed RN50 steps of
``bench.py``'s ``--zero`` arms (``_run_zero_arm``, :840-1000) on
``torch.distributed``, each rank on its share of the batch: ``ddp``
(:939-948), the model's BNs synced over the axis, the one flat grad
averaged, FusedLAMB replicated; ``zero`` (:920-938), the bf16 params
gathered from the shards, the grad reduce-scattered into
``DistributedFusedLAMB``'s shard update. ``DDPTrainer`` with
``optimizer="sgd"`` and a uint8 batch is ``examples/imagenet/main_amp.py``'s
``--data-parallel N --sync_bn`` step (:173-180, :224-300).
``LMTrainer`` is the FusedAdam step of ``tools/lm_bench.py`` (:255-272,
one device) for the decoder LM and, with the batch and loss keywords
passed through, of ``examples/seq2seq/train_translation.py`` for the
Seq2Seq Transformer; with ``microbatches`` or a ``loss_scale``, the
gradient accumulation of ``examples/lm/train_ring.py``.
``SeqParallelTrainer`` is ``train_ring.py``'s step itself (:121-146): an
LM with ``seq_axis``, each rank on its shard of the time axis, the flat
grads summed over the axis and the overflow flag maxed before the
update. All differentiate with respect to the flat fp32 master buffer
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

from typing import Optional

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch._stream import fold_key
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
from apex_tpu_torch.parallel import collectives as _C

__all__ = ["master_grad", "Trainer", "DDPTrainer", "ZeROTrainer",
           "LMTrainer", "SeqParallelTrainer", "DCGANTrainer"]


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
        self._setup(model, bn_state, opt_level, generator, device,
                    amp_overrides)
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

    def _setup(self, model, bn_state, opt_level, generator, device,
               amp_overrides):
        """Everything but the optimizer: the device, the model, the AMP
        handle, its half dtype and state, the BN state on the device and
        the dropout generator."""
        self.device = resolve_device(device)
        self.model = model
        _, self.handle = _amp.initialize(opt_level=opt_level, verbosity=0,
                                         **amp_overrides)
        # main_amp's ``cast_model_dtype or float32`` (:206)
        self.half = self.handle.policy.cast_model_dtype or torch.float32
        self.amp_state = self.handle.init_state(self.device)
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
            self._step_master(), self.table, self.half, objective)
        return flat_grad, loss, new_bn

    def _step_master(self):
        """The flat buffer the step differentiates against."""
        return self.opt.state[0].master

    def masters(self):
        """The flat fp32 masters."""
        return self.opt.state[0].master

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
        params = _flat.unflatten(self.masters(), self.table,
                                 dtype=self.half)
        logits, _ = self._apply(params, self._input(x), False)
        k = min(5, logits.shape[-1])
        hit = torch.topk(logits.float(), k, dim=-1).indices == \
            y.to(torch.int64)[:, None]
        return hit[:, 0].float().mean(), hit.any(dim=-1).float().mean()


def _pmean(t, axis_name):
    """The mean of a device scalar over the axis (``lax.pmean``)."""
    n = _C.group_size(axis_name)
    return _C.grouped_psum(t.reshape(1), axis_name)[0] / n


def _signed32(v: int) -> int:
    return v - (1 << 32) if v >= 1 << 31 else v


class DDPTrainer(Trainer):
    """``Trainer``'s step, data parallel over ``axis_name``: the model's
    BNs synced over the axis (``parallel.convert_syncbn_model``), the flat
    grad of this rank's batch averaged by ``ddp`` (one all-reduce, before
    the unscale, as bench.py:939-948 and main_amp.py:276-283), the
    optimizer and the scaler replicated, the loss averaged over the axis.
    Every rank must hold the same params and state. A ViT's dropout seeds
    differ by rank: each drawn seed is folded with the rank's position
    (``_stream.fold_key``), as main_amp folds the rank into its key
    (:264-267). Other keywords are ``Trainer``'s."""

    def __init__(self, model, params, bn_state=None, *,
                 axis_name: str = "data", ddp=None, **kw):
        super().__init__(model, params, bn_state, **kw)
        from apex_tpu_torch.parallel.distributed import \
            DistributedDataParallel
        self.axis_name = axis_name
        self.ddp = ddp if ddp is not None else \
            DistributedDataParallel(axis_name=axis_name)

    def draw_dropout_seeds(self):
        seeds = super().draw_dropout_seeds()
        if seeds is None:
            return None
        r = _C.axis_index(self.axis_name)
        keys = fold_key(torch.tensor([s & 0xFFFFFFFF for s in seeds]), r)
        return [_signed32(int(k)) for k in keys]

    def step(self, x, y, dropout_seeds=None):
        """One step on this rank's batch; returns the loss averaged over
        the axis (a device tensor). ``dropout_seeds`` are this rank's."""
        with _C.step_scope():
            flat_grad, loss, new_bn = self.loss_and_grad(x, y, dropout_seeds)
            flat_grad = self.ddp.average_gradients(flat_grad)
            self.apply_grads(flat_grad, new_bn)
            return _pmean(loss, self.axis_name)


class ZeROTrainer(Trainer):
    """bench.py's ``zero`` arm (:920-938): the bf16 params gathered from
    the masters' shards, forward and backward against the gathered flat
    buffer (its grad comes back bf16, as the JAX step's), the unscale, an
    overflow on any rank skipping the step on every shard, then
    ``DistributedFusedLAMB.shard_step`` (reduce-scatter, the shard's LAMB
    update) and the scaler's update; the loss averaged over the axis.
    ``state`` is this rank's :class:`ShardedState`; ``opt`` the optimizer,
    over ``num_shards`` ranks (the axis's size by default). The BN state
    and the scaler are replicated. ``lr`` is bench.py's 1e-3."""

    def __init__(self, model, params, bn_state=None, *,
                 axis_name: str = "data", num_shards=None,
                 opt_level: str = "O2", lr: float = 1e-3,
                 gather_dtype=None, device=None, **amp_overrides):
        from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB
        self._setup(model, bn_state, opt_level, None, device, amp_overrides)
        self.axis_name = axis_name
        n = num_shards if num_shards is not None else \
            _C.group_size(axis_name)
        self.opt = DistributedFusedLAMB(
            params, lr=lr, axis_name=axis_name, num_shards=n,
            model_dtype=self.half, gather_dtype=gather_dtype,
            device=self.device)
        self.table = self.opt.table
        self.state = self.opt.local_state(self.opt.init_state())

    def _step_master(self):
        return _C.all_gather(self.state.master.to(self.opt.gather_dtype),
                             self.axis_name)

    def apply_grads(self, flat_grad, new_bn):
        flat_grad, found_inf = self.handle.unscale(flat_grad.float(),
                                                   self.amp_state)
        # any rank's overflow skips the step on every shard
        found = _C.grouped_psum(found_inf.float().reshape(1),
                                self.axis_name)[0] > 0
        self.state, _ = self.opt.shard_step(self.state, flat_grad,
                                            found_inf=found, gather=False)
        self.amp_state = self.handle.update(self.amp_state, found)
        self.bn_state = new_bn
        return found

    def step(self, x, y, dropout_seeds=None):
        """One step on this rank's batch; returns the loss averaged over
        the axis (a device tensor)."""
        with _C.step_scope():
            flat_grad, loss, new_bn = self.loss_and_grad(x, y, dropout_seeds)
            self.apply_grads(flat_grad, new_bn)
            return _pmean(loss, self.axis_name)

    def masters(self):
        """The full fp32 masters, gathered from the shards."""
        return _C.all_gather(self.state.master, self.axis_name)


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


class SeqParallelTrainer(LMTrainer):
    """``examples/lm/train_ring.py``'s step (:121-146) on the ranks of the
    model's ``seq_axis``: each rank takes the flat master's grad of
    ``model.loss`` on its shard of the time axis (of every microbatch,
    with ``microbatches`` or a ``loss_scale``), the grads are summed over
    the axis — under the collectives' rule each rank's grad is its
    partial of the global loss, so their sum is the unsharded gradient
    (train_ring's ``pmean`` is the same sum under JAX's
    ``check_vma=False``, where each partial arrives n times over) — the
    overflow flag is maxed over the axis, and ``LMTrainer``'s FusedAdam
    update (and scaler update) runs replicated. ``step(tokens)`` takes
    this rank's int [B, T / n] shard and returns the global loss, the
    same on every rank. Every rank must hold the same params; the other
    keywords are ``LMTrainer``'s."""

    def __init__(self, model, params, **kw):
        if model.seq_axis is None:
            raise ValueError("SeqParallelTrainer needs a model with "
                             "seq_axis set")
        super().__init__(model, params, **kw)
        self.axis_name = model.seq_axis

    def global_grad(self, *batch, **loss_kw):
        """``(flat fp32 master grad summed over the axis, found_inf maxed
        over it or None, loss)`` of this rank's shard: the step before its
        update."""
        if self.handle is None:
            grad, loss = self.loss_and_grad(*batch, **loss_kw)
            found_inf = None
        else:
            grad, found_inf, loss = self.accumulate_grads(*batch, **loss_kw)
            found_inf = _C.pmax(found_inf, self.axis_name)
        return _C.psum(grad, self.axis_name), found_inf, loss

    def step(self, *batch, **loss_kw):
        """One step on this rank's shard; returns the loss as a device
        tensor."""
        with _C.step_scope():
            grad, found_inf, loss = self.global_grad(*batch, **loss_kw)
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

    def fit(self, steps: int, *, batch_size: int, nz: Optional[int] = None,
            seed: int = 0, telemetry=None, slo=None) -> list:
        """``examples/dcgan/main_amp.py``'s loop (:209-296) for ``steps``
        steps on its data stream (``RandomState(seed)`` normal reals × 0.5
        [B, 32, 32, 3] and latents [B, nz], made on the host a step and
        moved to ``device``). Every 10 steps the losses are fetched (the
        example prints them: a host sync at that cadence) and one
        interval row is returned for them.

        With ``telemetry`` (a ``prof.MetricsLogger``), as the example's
        ``--telemetry``: the step wrapped by ``track_recompiles``, a
        ``Watchdog`` (label ``dcgan``) beating each step, one interval
        ``step`` record every 10 steps (both losses and scaler 0's scale
        as device scalars) with a ``train_interval`` span, then one
        ``amp`` record a loss scaler, an ``amp_overflow`` record for each
        scaler that skipped (with ``numerics``: the trainer's censuses),
        with ``numerics`` the underflow census of G's final gradient, and
        the spans. ``slo`` (a ``prof.SLOMonitor``) is fed each interval's
        ``step_ms`` and, at the end, the worst scaler's ``skip_rate``.
        The caller closes ``telemetry``."""
        import time

        import numpy as np

        from apex_tpu_torch.prof.spans import SpanTracer
        from apex_tpu_torch.prof.watchdog import Watchdog
        nz = self.model.nz if nz is None else nz
        step, tracer, wd = self.step, None, None
        if telemetry is not None:
            step = telemetry.track_recompiles(self.step, "train_step")
            tracer = SpanTracer()
            wd = Watchdog(telemetry, min_interval_s=120.0, label="dcgan",
                          tracer=tracer).start()
        rs = np.random.RandomState(seed)
        rows = []
        t_int = time.perf_counter()
        try:
            for it in range(steps):
                real = torch.from_numpy(
                    (rs.randn(batch_size, 32, 32, 3) * 0.5).astype(
                        np.float32)).to(self.device)
                z = torch.from_numpy(rs.randn(batch_size, nz).astype(
                    np.float32)).to(self.device)
                d_l, g_l = step(real, z)
                if wd is not None:
                    wd.heartbeat()
                if (it + 1) % 10:
                    continue
                row = {"step": it + 1, "loss_d": float(d_l),
                       "loss_g": float(g_l)}
                now = time.perf_counter()
                row["step_ms"] = int_ms = (now - t_int) / 10 * 1e3
                rows.append(row)
                if telemetry is not None:
                    telemetry.log_step(it + 1, steps=10, step_ms=int_ms,
                                       loss=d_l, loss_g=g_l,
                                       loss_scale=self.amp_state[0].scale)
                    tn = tracer.now()
                    iv = tracer.begin("train_interval",
                                      t0=tn - (now - t_int), step=it + 1,
                                      steps=10)
                    tracer.end(iv, t1=tn)
                if slo is not None:
                    slo.observe("step_ms", int_ms, context={"step": it + 1})
                t_int = now
        finally:
            if wd is not None:
                wd.stop()
        st = self.amp_state
        if telemetry is not None:
            for i in range(3):          # one amp record per loss scaler
                telemetry.log_amp(self.handle.scalers[i], st[i], loss_id=i)
            if self.censuses is not None:
                # per-loss provenance: D's params for losses 0 and 1, G's
                # for loss 2
                metas = (self.d_meta, self.d_meta, self.g_meta)
                for i in range(3):
                    if int(st[i].overflow_count) > 0 and \
                            int(self.censuses[i].step) >= 0:
                        telemetry.log_overflow(metas[i], self.censuses[i],
                                               loss_id=i,
                                               loss_scale=st[i].scale)
                telemetry.log_numerics(self.g_meta,
                                       self.g_underflow_census(z),
                                       step=steps, loss_id=2)
        if slo is not None:
            # the multi-loss skip budget: the worst scaler's rate decides
            slo.observe("skip_rate", max(
                int(s.overflow_count) / max(int(s.step_count), 1)
                for s in st))
        if telemetry is not None:
            telemetry.log_spans(tracer)
        return rows

    def g_underflow_census(self, z):
        """``--numerics``' end-of-run sample (main_amp.py:276-284): the
        underflow census of G's unscaled gradient, through D, on ``z``."""
        from apex_tpu_torch.prof import numerics as _nu
        g_m, _, gp, dp = self.master_trees()
        (fgg,) = torch.autograd.grad(
            bce_logits(self.d_fwd(dp, self.g_fwd(gp, z)), 1.0), g_m)
        return _nu.underflow_census(fgg, table=self.g_table)
