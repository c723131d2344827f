"""ZeRO optimizers: ``DistributedFusedAdam`` / ``DistributedFusedLAMB`` —
counterpart of ``apex_tpu/contrib/optimizers/distributed.py``.

Weight-update sharding over an axis of ``num_shards`` ranks, as the JAX
package runs it inside ``shard_map``; here each rank runs
:meth:`shard_step` on its own shard:

    flat local grads [N]                            (the local backward)
      └─ psum_scatter  → summed grad shard [N/n]    (reduce-scatter)
      └─ the shard's Adam / LAMB update on (master, m, v)[N/n]
      └─ all_gather(gather_dtype) → params [N]      (bf16, or e5m2)

The flat layout aligns every segment to ``num_shards * 128`` elements, so
every shard boundary and every segment boundary is a 128-element row
boundary. The shard updates are the port's kernels where they compute
what the JAX update computes: ZeRO-Adam's is ``ops.multi_tensor.adam``
(the JAX ``R.adam_step``), elementwise, so its masters equal the
replicated ``FusedAdam``'s bit for bit when the summed gradient does;
ZeRO-LAMB's is ``lamb_phase1`` for the update term and the per-row sums
of p² and u², the per-segment sums of this shard's rows summed over the
shards in one all-reduce, then ``lamb_phase2`` with the trust ratio
(distributed.py:333-381). The global gradient norm and the rest are plain
PyTorch, as the JAX package leaves them to jnp.

Overflow: ``found_inf`` selects the old state, branchless; the step does
not advance. ``gradient_predivide`` divides by the world (shards ×
replicas) before the reduce; ``replica_axis_name`` adds a second level
(the reference's ``dwu_group_size``): the state shards over ``axis_name``
and replicates over the replica axis, whose all-reduce moves the shard
only. ``state_dict`` is per leaf, so ``load_state_dict`` on an optimizer
of another ``num_shards`` reshards.

State: :meth:`init_state` is the full buffers (the global view, as the JAX
package's), built once: it hands over the initial masters, so a rank keeps
no copy of the full buffer beside its state; :meth:`local_state` is a
rank's shard, and ``state_pspec``
gives the placements (``Shard(0)`` over ``axis_name``) for
``parallel.place_with_specs``. ``shard_step(..., gather=False)`` skips the
final gather, for a step that gathers at its start (XLA drops the unused
gather of the JAX step; an eager step must not run it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops import flat as _flat
from apex_tpu_torch.ops import kernels as K
from apex_tpu_torch.ops import multi_tensor as MT
from apex_tpu_torch.parallel import collectives as _C

__all__ = ["ShardedState", "DistributedFusedAdam", "DistributedFusedLAMB"]

ZERO_FORMAT = "apex_tpu.zero_state/1"


@dataclasses.dataclass
class ShardedState:
    """Optimizer state over the flat buffer: the full buffers, or a rank's
    ``[N/n]`` shard of each (``local_state``)."""
    master: torch.Tensor
    slots: dict
    step: torch.Tensor


class _DistributedBase:
    _slot_names: tuple = ()

    def __init__(self, params: Any, *, lr: float, axis_name: str = "data",
                 num_shards: int, model_dtype=torch.bfloat16,
                 gather_dtype=None, weight_decay: float = 0.0,
                 gradient_predivide: bool = True,
                 replica_axis_name: Optional[str] = None, device=None, **hp):
        self.device = resolve_device(device)
        self.axis_name = axis_name
        self.replica_axis_name = replica_axis_name
        self.num_shards = int(num_shards)
        self.model_dtype = model_dtype
        self.gather_dtype = gather_dtype or model_dtype
        self.gradient_predivide = gradient_predivide
        self.hp = {"lr": lr, "weight_decay": weight_decay, **hp}
        self._align = self.num_shards * _flat.DEFAULT_ALIGN
        tree = _flat.tree_map(lambda x: torch.as_tensor(x).to(self.device),
                              params)
        buf, table = _flat.flatten(tree, dtype=torch.float32,
                                   align=self._align)
        self.table = table
        self.total = buf.numel()
        self.shard_size = self.total // self.num_shards
        self._init_master = buf
        self._row_seg: dict = {}

    # -- state plumbing ----------------------------------------------------
    def init_state(self) -> ShardedState:
        """The full state (every rank the same): masters, zeroed slots,
        step 0. The initial masters go into it and the optimizer lets go
        of them, so it is called once; a later state comes from
        :meth:`load_state_dict`."""
        m = self._init_master
        if m is None:
            raise RuntimeError(
                "init_state() was called already: the optimizer keeps no "
                "copy of the initial masters; use load_state_dict()")
        self._init_master = None
        return ShardedState(master=m,
                            slots={k: torch.zeros_like(m)
                                   for k in self._slot_names},
                            step=torch.zeros((), dtype=torch.int32,
                                             device=m.device))

    def state_pspec(self, mesh=None) -> ShardedState:
        """Placements matching ``init_state()``: the buffers ``Shard(0)``
        over ``axis_name`` (the only dimension of a 1-D mesh), the step
        replicated."""
        from torch.distributed.tensor import Replicate, Shard
        if mesh is None:
            shard, rep = (Shard(0),), (Replicate(),)
        else:
            from apex_tpu_torch.parallel.mesh import placements
            shard = placements(mesh, {self.axis_name: 0})
            rep = placements(mesh, {})
        return ShardedState(master=shard,
                            slots={k: shard for k in self._slot_names},
                            step=rep)

    def local_state(self, state: ShardedState,
                    index: Optional[int] = None) -> ShardedState:
        """Shard ``index`` (this rank's position along ``axis_name`` by
        default) of a full state, as new tensors."""
        if index is None:
            index = _C.axis_index(self.axis_name)
        lo, hi = index * self.shard_size, (index + 1) * self.shard_size

        def cut(t):
            return t[lo:hi].clone()
        return ShardedState(master=cut(state.master),
                            slots={k: cut(v) for k, v in state.slots.items()},
                            step=state.step.clone())

    def set_lr(self, lr: float):
        self.hp["lr"] = float(lr)

    # -- helpers --------------------------------------------------------------
    def _rows_of(self, index: int) -> tuple:
        rows = self.shard_size // _flat.LANES
        return index * rows, (index + 1) * rows

    def _local_row_seg(self, index: int, device: torch.device):
        """int32 segment of each row of shard ``index``, and int64 rows of
        each segment in it (zero for segments elsewhere)."""
        key = (index, device)
        if key not in self._row_seg:
            lo, hi = self._rows_of(index)
            seg = self.table.row_segment_ids("cpu")[lo:hi].contiguous()
            lengths = torch.bincount(seg.long(),
                                     minlength=self.table.num_segments)
            self._row_seg[key] = (seg.to(device), lengths.to(device))
        return self._row_seg[key]

    def _world(self) -> int:
        world = self.num_shards
        if self.replica_axis_name is not None:
            world *= _C.group_size(self.replica_axis_name)
        return world

    def _reduce_scatter(self, grads, scale):
        """The summed (and, with ``gradient_predivide``, averaged) fp32
        grad shard of this rank, from local grads (a tree or a flat [N]
        buffer)."""
        if isinstance(grads, torch.Tensor):
            flat = grads.float()
        else:
            flat = _flat.flatten(grads, table=self.table,
                                 dtype=torch.float32)[0]
        if flat.numel() != self.total:
            flat = torch.nn.functional.pad(flat, (0, self.total
                                                  - flat.numel()))
        if not (isinstance(scale, (int, float)) and scale == 1.0):
            flat = flat * scale
        if self.gradient_predivide:
            flat = flat / self._world()
        shard = _C.psum_scatter(flat, self.axis_name)
        if self.replica_axis_name is not None:
            shard = _C.grouped_psum(shard, self.replica_axis_name)
        return shard

    def _all_gather_params(self, master_shard):
        gathered = _C.all_gather(master_shard.to(self.gather_dtype),
                                 self.axis_name)
        return _flat.unflatten(gathered.to(self.model_dtype), self.table)

    def _finish(self, state, new_master, new_slots, found_inf):
        new_step = state.step + 1
        if found_inf is not None:
            flag = torch.as_tensor(found_inf,
                                   device=new_master.device).to(torch.bool)

            def keep(old, new):
                return torch.where(flag, old, new)
            new_master = keep(state.master, new_master)
            new_slots = {k: keep(state.slots[k], v)
                         for k, v in new_slots.items()}
            new_step = keep(state.step, new_step)
        return ShardedState(master=new_master, slots=new_slots,
                            step=new_step)

    def shard_step(self, state: ShardedState, grads, *, found_inf=None,
                   scale=1.0, gather: bool = True):
        """One sharded update of this rank's shard ``state`` from its local
        grads. Returns ``(new_state, params tree in model dtype)``, or
        ``(new_state, None)`` with ``gather=False``."""
        g_shard = self._reduce_scatter(grads, scale)
        new_master, new_slots = self._update_shard(state, g_shard)
        new_state = self._finish(state, new_master, new_slots, found_inf)
        if not gather:
            return new_state, None
        return new_state, self._all_gather_params(new_state.master)

    def _update_shard(self, state, g_shard):
        raise NotImplementedError

    # -- checkpoint --------------------------------------------------------
    def state_dict_specs(self):
        return {"hp": dict(self.hp), "total": self.total,
                "num_shards": self.num_shards}

    def _full(self, buf):
        from torch.distributed.tensor import DTensor
        if isinstance(buf, DTensor):
            return buf.full_tensor()
        if buf.numel() == self.total:
            return buf
        return _C.all_gather(buf, self.axis_name)

    def state_dict_arrays(self, state: ShardedState) -> dict:
        """:meth:`state_dict` on the device: per-leaf trees, nothing read
        back to the host (a shard state is gathered over the axis)."""
        def unf(buf):
            return _flat.unflatten(self._full(buf), self.table)
        return {"format": ZERO_FORMAT,
                "master": unf(state.master),
                "slots": {k: unf(v) for k, v in state.slots.items()},
                "step": state.step, "hp": dict(self.hp),
                "num_shards": self.num_shards}

    def state_dict(self, state: ShardedState) -> dict:
        """The layout-independent checkpoint: masters and slots as per-leaf
        trees of host tensors, so :meth:`load_state_dict` under another
        ``num_shards`` reshards."""
        sd = self.state_dict_arrays(state)

        def host(tree):
            return _flat.tree_map(lambda t: t.detach().cpu().clone(), tree)
        step = state.step
        if hasattr(step, "full_tensor"):
            step = step.full_tensor()
        return {**sd, "master": host(sd["master"]),
                "slots": {k: host(v) for k, v in sd["slots"].items()},
                "step": int(step)}

    def load_state_dict(self, sd: dict) -> ShardedState:
        """The full :class:`ShardedState` in this optimizer's layout from a
        :meth:`state_dict` saved under any shard count."""
        if sd.get("format") != ZERO_FORMAT:
            raise ValueError(
                f"not a ZeRO state_dict (format={sd.get('format')!r})")
        dev = self.device

        def flat(tree):
            tree = _flat.tree_map(lambda a: torch.as_tensor(a).to(dev), tree)
            return _flat.flatten(tree, table=self.table,
                                 dtype=torch.float32)[0]
        return ShardedState(
            master=flat(sd["master"]),
            slots={k: flat(sd["slots"][k]) for k in self._slot_names},
            step=torch.tensor(int(sd["step"]), dtype=torch.int32,
                              device=dev))


class DistributedFusedAdam(_DistributedBase):
    """Sharded Adam/AdamW (the reference's ``DistributedFusedAdam``): the
    shard's update is the Adam kernel."""

    _slot_names = ("m", "v")

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, adam_w_mode=True, **kw):
        super().__init__(params, lr=lr, weight_decay=weight_decay,
                         betas=tuple(betas), eps=eps,
                         adam_w_mode=bool(adam_w_mode), **kw)

    def _update_shard(self, state, g_shard):
        hp = self.hp
        b1, b2 = hp["betas"]
        p, m, v = K.adam_step(
            g_shard, state.master, state.slots["m"], state.slots["v"],
            lr=float(hp["lr"]), beta1=b1, beta2=b2, eps=hp["eps"],
            step=state.step + 1,
            mode=K.MODE_DECOUPLED if hp["adam_w_mode"] else K.MODE_L2,
            bias_correction=True, weight_decay=hp["weight_decay"])
        return p, {"m": m, "v": v}


class DistributedFusedLAMB(_DistributedBase):
    """Sharded LAMB (the reference's ``DistributedFusedLAMB``): the LAMB
    kernels on the shard, the per-tensor norms as this shard's segment
    sums summed over the axis."""

    _slot_names = ("m", "v")

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                 weight_decay=0.01, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False, grad_averaging: bool = True,
                 bias_correction: bool = True, adam_w_mode: bool = True,
                 **kw):
        super().__init__(params, lr=lr, weight_decay=weight_decay,
                         betas=tuple(betas), eps=eps,
                         max_grad_norm=float(max_grad_norm),
                         use_nvlamb=bool(use_nvlamb),
                         grad_averaging=bool(grad_averaging),
                         bias_correction=bool(bias_correction),
                         adam_w_mode=bool(adam_w_mode), **kw)

    def _update_shard(self, state, g_shard):
        hp = self.hp
        b1, b2 = hp["betas"]
        p = state.master
        dev = p.device
        seg, lengths = self._local_row_seg(_C.axis_index(self.axis_name),
                                           dev)
        # the global grad norm: this shard's Σg², summed over the shards
        gsq = _C.grouped_psum(torch.sum(g_shard * g_shard).reshape(1),
                              self.axis_name)
        sc = MT.lamb_scalars(beta1=b1, beta2=b2, eps=hp["eps"],
                             step=state.step + 1,
                             bias_correction=hp["bias_correction"],
                             weight_decay=hp["weight_decay"],
                             grad_averaging=hp["grad_averaging"],
                             global_grad_norm=torch.sqrt(gsq[0]),
                             max_grad_norm=hp["max_grad_norm"], device=dev)
        mode = MT.MODE_DECOUPLED if hp["adam_w_mode"] else MT.MODE_L2
        u, m, v, prow, urow = MT.lamb_phase1(
            g_shard, p, state.slots["m"], state.slots["v"], sc, mode)
        # per-tensor ||p||² and ||u||²: this shard's rows of each segment,
        # then one all-reduce of both over the shards
        nseg = self.table.num_segments
        sums = _C.grouped_psum(torch.cat([MT.segment_sum(prow, lengths),
                                          MT.segment_sum(urow, lengths)]),
                               self.axis_name)
        pn, un = torch.sqrt(sums[:nseg]), torch.sqrt(sums[nseg:])
        ratio = MT._trust_ratio(pn, un, float(hp["lr"]), hp["use_nvlamb"],
                                hp["weight_decay"])
        new_p = MT.lamb_phase2(p, u, ratio, seg)
        return new_p, {"m": m, "v": v}
