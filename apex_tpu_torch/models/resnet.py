"""ResNet (18/34/50/101/152) — counterpart of ``apex_tpu/models/resnet.py``.

The same architecture, parameter names, shapes and layouts as the JAX
package: conv kernels HWIO, the fc weight ``[in, out]``, BN through the
port's ``SyncBatchNorm`` training core. Functional:
``init`` gives ``(params, state)`` trees, ``apply(params, state, x)``
gives ``(logits fp32, new_state)``.

Activations are NCHW tensors in ``torch.channels_last`` memory, so every
BN sees ``[N·H·W, C]`` rows as the JAX package's NHWC layout does; an
NHWC array ``a`` enters as ``a.permute(0, 3, 1, 2)``, which is exactly
that. Convolutions are ``F.conv2d`` and the fc a matmul, as the JAX package
leaves them to XLA. ``padding="SAME"`` pads as XLA does — ``lo = total //
2``, ``hi = total - lo`` — explicitly wherever the two differ (the 7×7/s2
stem, every 3×3/s2 conv), since PyTorch's symmetric padding would shift
the output grid by a pixel.

``bn_axis_name`` (and ``bn_axis_index_groups``) sync every BN's statistics
over that axis (``parallel.convert_syncbn_model`` sets them through
``replace``). Not ported: the space-to-depth stem (slice 7); it raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.flat import tree_map
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

__all__ = ["ResNet", "conv", "analytic_flops", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152"]


def _same_pad(n: int, k: int, s: int) -> tuple:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(params, x, *, stride: int = 1, padding="SAME"):
    """Conv of an NCHW x with an HWIO kernel, cast to x's dtype."""
    w = params.to(x.dtype).permute(3, 2, 0, 1)     # HWIO -> OIHW
    if padding == "VALID":
        return F.conv2d(x, w, stride=stride)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    ph = _same_pad(x.shape[2], w.shape[2], stride)
    pw = _same_pad(x.shape[3], w.shape[3], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, stride=stride)


def _conv_init(gen, kh, kw, cin, cout, dtype):
    # he_normal fan_out, as torchvision's kaiming_normal_(mode="fan_out")
    std = math.sqrt(2.0 / (kh * kw * cout))
    return std * torch.randn((kh, kw, cin, cout), generator=gen,
                             dtype=dtype)


class ResNet:
    """ResNet v1: ``block_sizes`` and ``bottleneck`` select the variant
    (ResNet-50: (3, 4, 6, 3), bottleneck). ``device`` is where ``init``
    puts the parameters: the card unless ``device="cpu"``."""

    def __init__(self, block_sizes: Sequence[int] = (3, 4, 6, 3),
                 bottleneck: bool = True, num_classes: int = 1000,
                 width: int = 64, bn_axis_name: Optional[str] = None,
                 bn_axis_index_groups=None, param_dtype=torch.float32,
                 stem: str = "conv", device=None):
        if stem == "space_to_depth":
            raise NotImplementedError(
                "the space-to-depth stem is not ported yet (ROADMAP.md "
                "Queue 1, slice 7)")
        if stem != "conv":
            raise ValueError(f"stem must be 'conv' or 'space_to_depth', "
                             f"got {stem!r}")
        self.block_sizes = tuple(block_sizes)
        self.bottleneck = bool(bottleneck)
        self.num_classes = int(num_classes)
        self.width = int(width)
        self.bn_axis_name = bn_axis_name
        self.bn_axis_index_groups = bn_axis_index_groups
        self.param_dtype = param_dtype
        self.stem = stem
        self.expansion = 4 if self.bottleneck else 1
        self.device = resolve_device(device)

    def replace(self, **kw) -> "ResNet":
        """Rebuilt with changed config (``parallel.convert_syncbn_model``
        flips the BNs to cross-replica this way)."""
        cfg = dict(block_sizes=self.block_sizes, bottleneck=self.bottleneck,
                   num_classes=self.num_classes, width=self.width,
                   bn_axis_name=self.bn_axis_name,
                   bn_axis_index_groups=self.bn_axis_index_groups,
                   param_dtype=self.param_dtype, stem=self.stem,
                   device=self.device)
        cfg.update(kw)
        return type(self)(**cfg)

    def _bn(self, c: int, fuse_relu: bool = False) -> SyncBatchNorm:
        return SyncBatchNorm(c, fuse_relu=fuse_relu,
                             axis_name=self.bn_axis_name,
                             axis_index_groups=self.bn_axis_index_groups,
                             channel_axis=1)

    # -- init -----------------------------------------------------------------
    def init(self, seed=0) -> tuple:
        """``(params, state)`` with weights drawn from a
        ``torch.Generator`` (a seed or a generator), in the JAX package's
        order, names and shapes."""
        gen = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(int(seed))
        dt = self.param_dtype
        params, state = {}, {}
        params["conv_stem"] = _conv_init(gen, 7, 7, 3, self.width, dt)
        params["bn_stem"], state["bn_stem"] = self._bn(self.width).init("cpu")
        cin = self.width
        for s, nblocks in enumerate(self.block_sizes):
            cmid = self.width * (2 ** s)
            cout = cmid * self.expansion
            for b in range(nblocks):
                stride = 2 if (s > 0 and b == 0) else 1
                blk_p, blk_s = {}, {}
                if self.bottleneck:
                    blk_p["conv1"] = _conv_init(gen, 1, 1, cin, cmid, dt)
                    blk_p["conv2"] = _conv_init(gen, 3, 3, cmid, cmid, dt)
                    blk_p["conv3"] = _conv_init(gen, 1, 1, cmid, cout, dt)
                    feats = (cmid, cmid, cout)
                else:
                    blk_p["conv1"] = _conv_init(gen, 3, 3, cin, cmid, dt)
                    blk_p["conv2"] = _conv_init(gen, 3, 3, cmid, cout, dt)
                    feats = (cmid, cout)
                for i, f in enumerate(feats, 1):
                    blk_p[f"bn{i}"], blk_s[f"bn{i}"] = self._bn(f).init("cpu")
                if b == 0 and (stride != 1 or cin != cout):
                    blk_p["conv_proj"] = _conv_init(gen, 1, 1, cin, cout, dt)
                    blk_p["bn_proj"], blk_s["bn_proj"] = \
                        self._bn(cout).init("cpu")
                params[f"stage{s}_block{b}"] = blk_p
                state[f"stage{s}_block{b}"] = blk_s
                cin = cout
        bound = 1.0 / math.sqrt(cin)
        params["fc_w"] = (torch.rand((cin, self.num_classes), generator=gen,
                                     dtype=dt) * 2 - 1) * bound
        params["fc_b"] = (torch.rand((self.num_classes,), generator=gen,
                                     dtype=dt) * 2 - 1) * bound

        def to(t):
            return t.to(self.device)
        return tree_map(to, params), tree_map(to, state)

    # -- apply ----------------------------------------------------------------
    def _block(self, p, st, x, *, cmid, stride, training):
        new_st = {}
        shortcut = x
        if "conv_proj" in p:
            shortcut = conv(p["conv_proj"], x, stride=stride)
            shortcut, new_st["bn_proj"] = self._bn(shortcut.shape[1]).apply(
                p["bn_proj"], st["bn_proj"], shortcut, training=training)
        if self.bottleneck:
            h = conv(p["conv1"], x, stride=1)
            h, new_st["bn1"] = self._bn(cmid, True).apply(
                p["bn1"], st["bn1"], h, training=training)
            h = conv(p["conv2"], h, stride=stride)
            h, new_st["bn2"] = self._bn(cmid, True).apply(
                p["bn2"], st["bn2"], h, training=training)
            h = conv(p["conv3"], h, stride=1)
            # the last BN fuses the residual add and the relu
            h, new_st["bn3"] = self._bn(h.shape[1], True).apply(
                p["bn3"], st["bn3"], h, z=shortcut, training=training)
        else:
            h = conv(p["conv1"], x, stride=stride)
            h, new_st["bn1"] = self._bn(cmid, True).apply(
                p["bn1"], st["bn1"], h, training=training)
            h = conv(p["conv2"], h, stride=1)
            h, new_st["bn2"] = self._bn(h.shape[1], True).apply(
                p["bn2"], st["bn2"], h, z=shortcut, training=training)
        return h, new_st

    def apply(self, params: dict, state: dict, x: torch.Tensor,
              training: bool = True) -> tuple:
        """x: (N, 3, H, W), best in channels_last memory. Returns (logits
        fp32 [N, classes], new_state)."""
        x = x.contiguous(memory_format=torch.channels_last)
        new_state = {}
        h = conv(params["conv_stem"], x, stride=2)
        h, new_state["bn_stem"] = self._bn(self.width, True).apply(
            params["bn_stem"], state["bn_stem"], h, training=training)
        h = F.max_pool2d(h, 3, 2, padding=1)          # pads with -inf
        for s, nblocks in enumerate(self.block_sizes):
            cmid = self.width * (2 ** s)
            for b in range(nblocks):
                name = f"stage{s}_block{b}"
                stride = 2 if (s > 0 and b == 0) else 1
                h, new_state[name] = self._block(
                    params[name], state[name], h, cmid=cmid, stride=stride,
                    training=training)
        # mean pool with an fp32 sum, in the activation dtype (jnp.mean);
        # the head upcasts both operands: half values are exact in fp32,
        # so this is the JAX package's half matmul with an fp32
        # accumulator up to summation order
        h = h.mean(dim=(2, 3), dtype=torch.float32).to(h.dtype)
        logits = h.float() @ params["fc_w"].float() \
            + params["fc_b"].float()
        return logits, new_state

    def __call__(self, params, state, x, training=True):
        return self.apply(params, state, x, training=training)


def analytic_flops(model: ResNet, image: int) -> float:
    """Analytic forward FLOPs per image (2 per MAC, every conv and the
    fc), as resnet.py:275-307; training is about 3× this."""
    def up(n, s):
        return -(-n // s)

    flops = 0.0
    h = up(image, 2)
    flops += 2 * 7 * 7 * 3 * model.width * h * h
    h = up(h, 2)
    cin = model.width
    for s, nblocks in enumerate(model.block_sizes):
        cmid = model.width * (2 ** s)
        cout = cmid * model.expansion
        for b in range(nblocks):
            stride = 2 if (s > 0 and b == 0) else 1
            hout = up(h, stride)
            if model.bottleneck:
                flops += 2 * 1 * 1 * cin * cmid * h * h
                flops += 2 * 3 * 3 * cmid * cmid * hout * hout
                flops += 2 * 1 * 1 * cmid * cout * hout * hout
            else:
                flops += 2 * 3 * 3 * cin * cmid * hout * hout
                flops += 2 * 3 * 3 * cmid * cout * hout * hout
            if b == 0 and (stride != 1 or cin != cout):
                flops += 2 * 1 * 1 * cin * cout * hout * hout
            cin = cout
            h = hout
    flops += 2 * cin * model.num_classes
    return flops


def resnet18(**kw) -> ResNet:
    return ResNet(block_sizes=(2, 2, 2, 2), bottleneck=False, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(block_sizes=(3, 4, 6, 3), bottleneck=False, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(block_sizes=(3, 4, 6, 3), bottleneck=True, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(block_sizes=(3, 4, 23, 3), bottleneck=True, **kw)


def resnet152(**kw) -> ResNet:
    return ResNet(block_sizes=(3, 8, 36, 3), bottleneck=True, **kw)
