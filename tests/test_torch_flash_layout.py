"""The Hopper flash kernels' host-side layout, on the CPU.

The forward (``ops/cuda/csrc/flash_fwd.cu``), dq and dk/dv
(``ops/cuda/csrc/flash_bwd.cu``) copy their tiles by TMA. The wrappers
describe each tensor's map (``tma_layout``: the dims innermost first, (D,
S, BH); the row and bh strides in bytes, which TMA takes only in multiples
of 16; the box, 64 head-dim elements of 128 bytes by 64 rows by one bh),
the grid's row blocks (``row_blocks``: 128 rows a block) and the views they
hand over (``_tma_readable``). The kernels encode the maps from these
numbers and refuse a layout that does not match the tensor, so what is
tested here is what the card reads.
"""

import pytest
import torch

from apex_tpu_torch.ops import flash_attn as FA


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def test_box_is_one_swizzle_span_by_one_staged_tile():
    assert FA.TMA_BOX == (64, 64, 1) and FA.BLOCK_ROWS == 128
    assert FA.TMA_BOX[0] * 2 == 128          # bytes: the 128-byte swizzle


@pytest.mark.parametrize("bh,s,d", [(3, 100, 64), (128, 4095, 64),
                                    (384, 2048, 128), (1536, 197, 64)])
def test_contiguous_layout(bh, s, d):
    assert FA.tma_layout(_bf16(bh, s, d)) == (d, s, bh, 2 * d, 2 * s * d,
                                              64, 64, 1)


@pytest.mark.parametrize("d", [64, 128])
def test_time_major_view_keeps_its_strides(d):
    """``_split_heads``'s [BH, S, D] view of a time-major [S, B·H, D]
    tensor (strides (D, B·H·D, 1)): the map reads it in place, rows
    B·H·D apart and heads D apart."""
    t, bh = 70, 4
    x = _bf16(t, bh, d).transpose(0, 1)
    assert not x.is_contiguous()
    assert FA._tma_readable(x) is x
    assert FA.tma_layout(x) == (d, t, bh, 2 * bh * d, 2 * d, 64, 64, 1)


def test_a_dim_of_one_takes_the_packed_stride():
    """A size-1 dim's stride is arbitrary in PyTorch and never read by the
    kernel; the map gets the packed layout's instead (TMA refuses strides
    that are not multiples of 16 bytes)."""
    one_bh = _bf16(1, 40, 64).as_strided((1, 40, 64), (3, 64, 1))
    assert FA.tma_layout(one_bh) == (64, 40, 1, 128, 40 * 128, 64, 64, 1)
    one_row = _bf16(5, 1, 128).as_strided((5, 1, 128), (128, 7, 1))
    assert FA.tma_layout(one_row) == (128, 1, 5, 256, 256, 64, 64, 1)


@pytest.mark.parametrize("make", [
    lambda: _bf16(1, 64).expand(4, 16, 64),           # bh broadcast
    lambda: _bf16(4, 1, 64).expand(4, 16, 64),        # rows broadcast
    lambda: _bf16(4, 16, 68)[..., :64],               # rows 136 bytes
    lambda: _bf16(2, 16, 128)[:, :, ::2],             # D not contiguous
    lambda: _bf16(4 * 16 * 64 + 1)[1:].view(4, 16, 64),  # base off 16 B
])
def test_what_tma_cannot_read_is_copied(make):
    x = make()
    y = FA._tma_readable(x)
    assert y is not x and y.is_contiguous() and torch.equal(y, x)


@pytest.mark.parametrize("make", [
    lambda: _bf16(3, 50, 64),
    lambda: _bf16(3, 50, 128).transpose(0, 1).contiguous().transpose(0, 1),
    lambda: _bf16(6, 50, 64)[::2],
    lambda: _bf16(3, 50, 192)[..., 64:],
    lambda: _bf16(4, 16, 72)[..., :64],               # rows 144 bytes
    lambda: _bf16(1, 64).expand(4, 16, 64),
    lambda: _bf16(5, 1, 128).as_strided((5, 1, 128), (128, 7, 1)),
])
def test_every_readable_layout_has_strides_tma_takes(make):
    """Whatever the wrappers hand the kernel: the last dim contiguous, the
    row and bh strides nonzero multiples of 16 bytes."""
    y = FA._tma_readable(make())
    d, s, bh, row, bhs, *box = FA.tma_layout(y)
    assert (d, s, bh) == (y.shape[2], y.shape[1], y.shape[0])
    assert y.stride(-1) == 1 and y.data_ptr() % 16 == 0
    assert row > 0 and bhs > 0 and row % 16 == 0 and bhs % 16 == 0
    assert tuple(box) == FA.TMA_BOX


@pytest.mark.parametrize("rows,blocks", [(1, 1), (127, 1), (128, 1),
                                         (129, 2), (197, 2), (255, 2),
                                         (256, 2), (2048, 16), (4095, 32)])
def test_row_blocks(rows, blocks):
    """The grid of the forward, dq and dk/dv alike: one block per 128 rows
    (the C side refuses any other count)."""
    assert FA.row_blocks(rows) == blocks == -(-rows // FA.BLOCK_ROWS)


def test_maps_pack_four_layouts_in_order():
    """The C array the entry points take: q, k, v and dO, 8 ints each."""
    q, do = _bf16(2, 30, 64), _bf16(2, 30, 64)
    k, v = _bf16(2, 50, 64), _bf16(2, 50, 64)[:, :, :]
    maps = FA._tma_maps(q, k, v, do)
    assert len(maps) == 32
    assert list(maps) == [x for t in (q, k, v, do)
                          for x in FA.tma_layout(t)]


def _views(d):
    """q, k, v as the forward's callers hand them over: contiguous, the
    time-major split's views (strides (D, B·H·D, 1)) and k, v broadcast
    over bh (a stride of 0)."""
    t, bh = 70, 4
    tm = _bf16(t, bh, d).transpose(0, 1)
    return {
        "contiguous": (_bf16(bh, 30, d), _bf16(bh, t, d), _bf16(bh, t, d)),
        "time_major": (tm, tm, tm),
        "broadcast": (_bf16(bh, 30, d), _bf16(1, t, d).expand(bh, t, d),
                      _bf16(1, t, d).expand(bh, t, d)),
    }


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kind", ["contiguous", "time_major", "broadcast"])
def test_forward_maps_of_q_k_v(kind, d):
    """The forward takes q, k and v through ``_tma_readable`` and hands the
    C side their three maps, 8 ints each, in that order: views TMA reads
    in place keep their strides; a broadcast view becomes one contiguous
    copy (TMA takes no zero stride)."""
    views = _views(d)[kind]
    ts = [FA._tma_readable(t) for t in views]
    for src, t in zip(views, ts):
        if kind == "broadcast" and src.stride(0) == 0:
            assert t is not src and t.is_contiguous() and torch.equal(t, src)
        else:
            assert t is src
    maps = FA._tma_maps(*ts)
    assert len(maps) == 24
    assert list(maps) == [x for t in ts for x in FA.tma_layout(t)]
    bh = ts[0].shape[0]
    for t, lay in zip(ts, (maps[0:8], maps[8:16], maps[16:24])):
        assert tuple(lay[:3]) == (d, t.shape[1], bh)
        assert tuple(lay[5:]) == FA.TMA_BOX
    if kind == "time_major":
        assert tuple(maps[3:5]) == (2 * bh * d, 2 * d)
    else:
        assert all(tuple(maps[8 * i + 3:8 * i + 5])
                   == (2 * d, 2 * d * ts[i].shape[1]) for i in range(3))
