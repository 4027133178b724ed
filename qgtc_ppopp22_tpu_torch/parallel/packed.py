"""Multi-device execution of the packed path, the one the engines run.

Counterpart of ``qgtc_ppopp22_tpu/parallel/packed.py``.
``parallel/sharded.py`` runs the mesh over dense int8 digit planes, 8x
the packed footprint; this module runs the same (dp, sp) meshes on the
storage format of the single-device engines: the M-packed adjacency words
of :class:`~qgtc_ppopp22_tpu_torch.ops.packmm.PackedTensor`
(``graph/batching.ClusterBatch.a_words``).

* :func:`dp_mega_epoch_packed`: batches over ``dp``, each dp row running
  the whole-model kernel K1 (``ops/fused_model.fused_model_epoch``) on its
  share of the stacked bucket, with the zero-block schedule's rows sharded
  with their batches. Nothing crosses devices.
* :func:`dp_sp_epoch_packed`: each batch's adjacency word rows over ``sp``
  too (a shard holds whole 256-row pack groups, so the layout needs no
  repacking). Each aggregation is the ring of
  :func:`~qgtc_ppopp22_tpu_torch.parallel.sharded.ring_aggregate`, its
  shard GEMM the packed kernel K2 to raw int32
  (:func:`~qgtc_ppopp22_tpu_torch.ops.packmm.packmm_to_i32`); the updates
  are K3 (``digitmm_to_digits`` / ``digitmm_to_f32``). A shard's words
  are cut into their sp column blocks once, when they are placed
  (:func:`shard_packed_batches`): the layout packs along M, so a column
  range is a last-axis slice, made contiguous there and never again.

Bytes per hop (an arithmetic model, not a measurement). Per aggregation
every shard sends ``sp - 1`` hiddens of ``rows_loc x 128 x digit planes``
int8 bytes to the next shard: the digit planes are padded to 128 columns,
whatever the hidden width. C1 (hidden 16, 2-bit: one digit plane) at its
pn 2560 bucket: at sp 2 one hop of 1280 x 128 = 160 KiB, at sp 4 three
hops of 640 x 128 = 80 KiB (240 KiB); three aggregations a batch. At the
data sheets' rates, one direction of NVLink 4 on an H100 SXM (450 GB/s of
its 900 GB/s both ways) carries a hop in 0.36 / 0.18 us, one direction of
PCIe 5.0 x16 (64 GB/s) in 2.6 / 1.3 us.
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional, Sequence, Union

import torch

from qgtc_ppopp22_tpu_torch.ops import fused_model
from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor
from qgtc_ppopp22_tpu_torch.ops.packmm import PACK_GROUP, PackedTensor, packmm_to_i32
from qgtc_ppopp22_tpu_torch.parallel.sharded import (
    Mesh,
    Sharded,
    Weights,
    replicate,
    ring_aggregate,
    shard_rows,
    sharded_forward,
)

__all__ = ["dp_sp_epoch_packed", "dp_mega_epoch_packed", "shard_packed_batches"]

_RPW = 32  # adjacency rows per packed word (1-bit)


def _column_blocks(mesh: Mesh, a_stack: torch.Tensor) -> Sharded:
    """Packed words [B, nd_a, pn/32, pn] -> per shard ``(i, j)`` its word rows
    cut into sp contiguous column blocks, int32[B/dp, sp, nd_a, rows_loc/32,
    rows_loc] on its device."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    B, nd_a, mw, pn = a_stack.shape
    bl, rows_loc = B // dp, pn // sp
    mw_loc = rows_loc // _RPW
    parts = []
    for i in range(dp):
        row = []
        for j in range(sp):
            w = a_stack[i * bl:(i + 1) * bl, :, j * mw_loc:(j + 1) * mw_loc]
            row.append(w.reshape(bl, nd_a, mw_loc, sp, rows_loc).permute(0, 3, 1, 2, 4).contiguous()
                       .to(mesh.devices[i][j]))
        parts.append(tuple(row))
    return Sharded(tuple(parts), "blocks")


def _check_stacks(mesh: Mesh, B: int, pn: int, sp_rows: bool) -> None:
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if B % dp:
        raise ValueError(f"B={B} not divisible by dp={dp}")
    if sp_rows and pn % (sp * PACK_GROUP):
        raise ValueError(f"pn={pn} must divide by sp*{PACK_GROUP}={sp * PACK_GROUP} (whole pack groups per shard)")


def shard_packed_batches(mesh: Mesh, a_stack: torch.Tensor, x_stack: torch.Tensor, sp_shard_rows: bool = True):
    """Place stacked packed batches -> ``(a, x)`` :class:`Sharded`.

    ``a_stack``: words [B, nd_a, pn/32, pn] (or [B, pn/32, pn] for the mega
    path); ``x_stack``: feature digits [B, nd_x, pn, xp]. With
    ``sp_shard_rows`` the batch axis goes over dp and the rows over sp, the
    words cut into their column blocks (:func:`_column_blocks`); otherwise
    only the batch axis is split (the mega path, sp 1)."""
    B, pn = a_stack.shape[0], a_stack.shape[-1]
    _check_stacks(mesh, B, pn, sp_shard_rows)
    if sp_shard_rows:
        return _column_blocks(mesh, a_stack), shard_rows(mesh, x_stack)
    if mesh.shape["sp"] != 1:
        raise ValueError("the batch-only placement needs sp=1")
    return shard_rows(mesh, a_stack, 1), shard_rows(mesh, x_stack)


def dp_sp_epoch_packed(
    mesh: Mesh,
    a_stack: Union[torch.Tensor, Sharded],  # int32[B, nd_a, pn/32, pn] M-packed words
    x_stack: Union[torch.Tensor, Sharded],  # int8[B, nd_x, pn, xp] feature digits
    ws: Weights,
    out_bits: int,
    x_bits: int = 2,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
    x_cols: Optional[int] = None,
) -> Sharded:
    """The mesh step on the packed format: batches over ``dp``, adjacency
    word rows and feature rows over ``sp``, every aggregation the ring of K2
    raw-int32 shard GEMMs. CPU stacks are placed here; a :class:`Sharded`
    pair from :func:`shard_packed_batches` is used as placed. ``B`` must
    divide by dp and ``pn`` by ``sp * 256``. ``x_cols``: the features' real
    columns (the contraction against the first weight's logical rows).
    Semantics of ``qgcn_forward`` / ``qgin_forward`` on each batch; returns
    the float32 logits [B, pn, classes], rows on their shards."""
    if model not in ("gcn", "gin"):
        raise ValueError(model)
    if not isinstance(a_stack, Sharded):
        a_stack, x_stack = shard_packed_batches(mesh, a_stack, x_stack)
    elif a_stack.row_axis != "blocks":
        raise ValueError("dp_sp_epoch_packed takes the words as shard_packed_batches places them")
    sp = mesh.shape["sp"]
    blk0 = a_stack.parts[0][0]
    rows_loc = blk0.shape[-1]
    xc = x_stack.parts[0][0].shape[3] if x_cols is None else int(x_cols)
    wsd = replicate(ws, mesh.distinct())
    parts = []
    for i, (a_row, x_row) in enumerate(zip(a_stack.parts, x_stack.parts)):
        outs = []
        for b in range(a_row[0].shape[0]):
            blocks = [[PackedTensor(words=a[b, k], shape=(rows_loc, rows_loc), bits=1) for k in range(sp)]
                      for a in a_row]
            hs = [DigitTensor(digits=x[b], shape=(rows_loc, xc), bits=x_bits) for x in x_row]
            agg = functools.partial(ring_aggregate, mesh, i, blocks, gemm_i32=packmm_to_i32)
            outs.append(sharded_forward(mesh, i, hs, wsd, out_bits, model, agg, shifts))
        parts.append(tuple(torch.stack([o[j] for o in outs]) for j in range(sp)))
    return Sharded(tuple(parts), 1)


def _part(t, mesh: Mesh, i: int) -> Optional[torch.Tensor]:
    """dp row ``i``'s share of a batch-axis stack on its device."""
    if t is None:
        return None
    if isinstance(t, Sharded):
        return t.parts[i][0]
    bl = t.shape[0] // mesh.shape["dp"]
    return t[i * bl:(i + 1) * bl].to(mesh.devices[i][0])


def dp_mega_epoch_packed(
    mesh: Mesh,
    a_stack: Union[torch.Tensor, Sharded],  # int32[B, pn/32, pn] M-packed 1-bit words
    x_stack: Union[torch.Tensor, Sharded],  # int8[B, nd_x, pn, xp] digits, or [B, 1, pn, xp] levels
    ws: Weights,
    out_bits: int,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
    resident_a: Optional[bool] = None,
    chunk_occ=None,
    out_cols: Optional[int] = None,
    x_cols: Optional[int] = None,
    blk_sched=None,
    x_levels_bits: Optional[int] = None,
    packed: Optional[Mapping[torch.device, "fused_model.MegaWeights"]] = None,
) -> Sharded:
    """The whole-model kernel K1, batches sharded over ``dp``: each dp row
    launches :func:`~qgtc_ppopp22_tpu_torch.ops.fused_model.fused_model_epoch`
    once on its share of the stack, its rows of ``chunk_occ`` /
    ``blk_sched`` (exclusive) with it, so each device runs the schedule the
    single-device engine would. ``B`` must divide by dp; the mesh's ``sp``
    must be 1. Stacks are CPU tensors (each share moved here) or
    :class:`Sharded` placements; ``packed``: K1's weight operands per device
    (built per launch where absent). Returns the float32 logits [B, pn, oc],
    one part per dp row."""
    if mesh.shape["sp"] != 1:
        raise ValueError("dp_mega_epoch_packed needs sp=1 (use dp_sp_epoch_packed for row-sharded batches)")
    if chunk_occ is not None and blk_sched is not None:
        raise ValueError("chunk_occ and blk_sched are exclusive")
    if not isinstance(a_stack, Sharded):
        _check_stacks(mesh, a_stack.shape[0], a_stack.shape[-1], False)
    wsd = replicate(ws, mesh.distinct())
    tier = {} if resident_a is None else dict(resident_a=resident_a)
    parts = []
    for i, row in enumerate(mesh.devices):
        dev = row[0]
        parts.append((fused_model.fused_model_epoch(
            _part(a_stack, mesh, i), _part(x_stack, mesh, i), wsd[dev], out_bits, model=model, shifts=shifts,
            out_cols=out_cols, blk_sched=_part(blk_sched, mesh, i), x_cols=x_cols, x_levels_bits=x_levels_bits,
            chunk_occ=_part(chunk_occ, mesh, i), packed=None if packed is None else packed[dev], **tier),))
    return Sharded(tuple(parts), None)
