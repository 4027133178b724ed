"""Multi-device execution: a (dp, sp) mesh of devices and the row-sharded
quantized forward over digit planes.

Counterpart of ``qgtc_ppopp22_tpu/parallel/sharded.py``. The reference is
single-GPU; the JAX package adds two composable axes, and so does this
one:

* ``dp``: data parallelism over cluster batches. Each device runs whole
  batches; nothing crosses devices.
* ``sp``: graph-shard parallelism within a batch. Shard ``j`` owns the
  adjacency rows ``j * rows_loc ... (j + 1) * rows_loc`` and the same rows
  of every hidden. Each aggregation ``A @ H`` either gathers ``H`` on every
  shard (``agg_mode='gather'``) or passes it around the ring while each
  shard multiplies the column block of the shard whose hidden it holds
  (``'ring'``, the default): partial sums in int32, one hop a rotation.
  ``H @ W`` needs nothing: the weights are on every device.

JAX runs the mesh from one controller (``shard_map``, ``ppermute``). So
does this package: one process drives every device of its mesh, the
hiddens move with ``Tensor.to`` on a copy stream of each shard, ordered
by CUDA events, and each kernel launches on its device's current stream.
A :class:`Mesh` may name one device more than once (``["cuda:0"] * 4``,
or ``["cpu"] * 8`` for the tests): the analog of JAX's virtual CPU
devices, and the only way one GPU runs the ``sp > 1`` path with its real
kernels. A process per GPU over NCCL could not: NCCL refuses two ranks on
one GPU. Across processes (``parallel/multihost.py``) dp spans them and sp
stays inside each one, as in JAX, so no tensor crosses processes on the
data path.

This module holds the dense digit-plane path (a 1-bit digit-plane A,
``ops/digitmm``'s kernel for every GEMM); ``parallel/packed.py`` holds the
packed path the engines run.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from qgtc_ppopp22_tpu_torch.ops.digitmm import digitmm_to_digits, digitmm_to_f32, digitmm_to_i32
from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor, split_digits
from qgtc_ppopp22_tpu_torch.ops.quantize import requantize_wrapped

Weights = Union[Sequence[DigitTensor], Mapping[torch.device, Sequence[DigitTensor]]]


class Mesh:
    """A dp x sp grid of ``torch.device``\\ s (``devices[i][j]``: dp row
    ``i``, sp shard ``j``), with ``shape == {"dp": dp, "sp": sp}``, and a
    copy stream for each CUDA shard (made at first use)."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.devices = [list(row) for row in grid]
        self.shape = {"dp": len(self.devices), "sp": len(self.devices[0])}
        self._streams: Dict[Tuple[int, int], torch.cuda.Stream] = {}

    def distinct(self) -> List[torch.device]:
        """The mesh's devices, each once, in grid order."""
        out: List[torch.device] = []
        for d in (d for row in self.devices for d in row):
            if d not in out:
                out.append(d)
        return out

    def synchronize(self) -> None:
        for d in self.distinct():
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def copy_stream(self, i: int, j: int) -> torch.cuda.Stream:
        if (i, j) not in self._streams:
            self._streams[(i, j)] = torch.cuda.Stream(device=self.devices[i][j])
        return self._streams[(i, j)]

    def send(self, t: torch.Tensor, i: int, j: int, k: int, after: Optional[torch.cuda.Event]):
        """Shard ``(i, j)``'s tensor ``t`` as a copy on shard ``(i, k)``'s
        device -> ``(copy, event)``. On CUDA the copy runs on shard ``j``'s copy
        stream once ``t`` is ready (after the event ``after``, else after
        the work queued so far on ``t``'s device), and the event marks its
        end: a reader waits on it (:meth:`receive`). A copy is made even on
        the same device, so a one-GPU mesh moves the ring's bytes too. On the
        CPU the tensor itself (no event)."""
        dst = self.devices[i][k]
        if t.device.type != "cuda":
            return t.to(dst), None
        cs = self.copy_stream(i, j)
        if after is None:
            cs.wait_stream(torch.cuda.current_stream(t.device))
        else:
            cs.wait_event(after)
        with contextlib.ExitStack() as ctx:
            ctx.enter_context(torch.cuda.stream(cs))
            if dst != t.device:  # a copy between GPUs also orders with the destination's current stream
                ctx.enter_context(torch.cuda.stream(self.copy_stream(i, k)))
            out = t.to(dst, non_blocking=True, copy=True)
            done = torch.cuda.Event()
            done.record(cs)
        t.record_stream(cs)
        return out, done

    @staticmethod
    def receive(t: torch.Tensor, done: Optional[torch.cuda.Event]) -> torch.Tensor:
        """Order the reads of ``t`` on its device's current stream after the
        copy that made it (:meth:`send`)."""
        if done is not None:
            cur = torch.cuda.current_stream(t.device)
            cur.wait_event(done)
            t.record_stream(cur)
        return t


def make_mesh(dp: int = 1, sp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """The (dp, sp) :class:`Mesh` over the first ``dp * sp`` of ``devices``
    (which may repeat a device), or over ``cuda:0 ... cuda:dp*sp-1``. Raises
    where fewer devices are given or present (as JAX's ``make_mesh`` beyond
    ``jax.device_count()``), and where a CUDA device is asked for without
    CUDA."""
    need = dp * sp
    if dp < 1 or sp < 1:
        raise ValueError(f"mesh ({dp}, {sp}): both axes must be >= 1")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh over CUDA devices requested but CUDA is not available")
        have = torch.cuda.device_count()
        if need > have:
            raise ValueError(f"need {need} devices, have {have}")
        devs = [torch.device("cuda", i) for i in range(need)]
    else:
        devs = [torch.device(d) for d in devices]
        if len(devs) < need:
            raise ValueError(f"need {need} devices, have {len(devs)}")
        devs = devs[:need]
        if any(d.type == "cuda" for d in devs) and not torch.cuda.is_available():
            raise RuntimeError("a mesh over CUDA devices requested but CUDA is not available")
        devs = [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
                for d in devs]
    return Mesh([devs[i * sp:(i + 1) * sp] for i in range(dp)])


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A stacked array split over a mesh: ``parts[i][j]`` is dp row ``i``'s
    share of the batch axis (axis 0) on shard ``(i, j)``'s device, the rows
    at ``row_axis`` split over sp (None: each shard of a row holds them
    all; ``"blocks"``: the packed ring's column blocks, ``parts[i][j][b, k]``
    shard ``j``'s adjacency columns of shard ``k``)."""

    parts: Tuple[Tuple[torch.Tensor, ...], ...]
    row_axis: Union[int, None, str] = None

    def gather(self, device="cpu") -> torch.Tensor:
        """The whole stack on ``device``: rows joined, then dp rows."""
        if self.row_axis == "blocks":
            raise ValueError("column blocks do not gather; stage the stack again")
        rows = [torch.cat([p.to(device) for p in row], dim=self.row_axis) if self.row_axis is not None
                else row[0].to(device) for row in self.parts]
        return torch.cat(rows, dim=0)


def replicate(ws: Weights, devices: Sequence[torch.device]) -> Dict[torch.device, List[DigitTensor]]:
    """The weights on each device (a mapping is taken as it is)."""
    if isinstance(ws, Mapping):
        return dict(ws)
    return {d: [w.to(d) for w in ws] for d in devices}


def shard_rows(mesh: Mesh, stack: torch.Tensor, row_axis: int = 2) -> Sharded:
    """A stack [B, ...] split over the mesh: the batch axis over dp (B must
    divide by it), the axis ``row_axis`` over sp; each part contiguous on
    its device."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    B, rows = stack.shape[0], stack.shape[row_axis]
    if B % dp or rows % sp:
        raise ValueError(f"stack {tuple(stack.shape)}: B={B} must divide by dp={dp}, rows={rows} by sp={sp}")
    bl, rl = B // dp, rows // sp
    return Sharded(tuple(tuple(stack[i * bl:(i + 1) * bl].narrow(row_axis, j * rl, rl).contiguous()
                               .to(mesh.devices[i][j]) for j in range(sp)) for i in range(dp)), row_axis)


def shard_batches(mesh: Mesh, a_stack: torch.Tensor, x_stack: torch.Tensor) -> Tuple[Sharded, Sharded]:
    """Place stacked digit-plane batches ``a_stack`` [B, nd_a, n, n] and
    ``x_stack`` [B, nd_x, n, d]: batches over dp, rows over sp."""
    return shard_rows(mesh, a_stack), shard_rows(mesh, x_stack)


def _levels_to_digits(levels: torch.Tensor, bits: int, logical_shape, padded_cols: Optional[int] = None) -> DigitTensor:
    """Levels [rows, n] -> a ``DigitTensor`` of ``logical_shape``, its columns
    zero-padded to ``padded_cols`` (the DigitTensor convention: padded
    planes plus the logical shape; level-0 padding is exact)."""
    rows, n = levels.shape
    if padded_cols is not None and padded_cols > n:
        levels = torch.nn.functional.pad(levels, (0, padded_cols - n))
    return DigitTensor(digits=split_digits(levels, bits), shape=tuple(logical_shape), bits=bits)


def ring_aggregate(mesh: Mesh, i: int, blocks: Sequence[Sequence], hs: Sequence[DigitTensor],
                   out_bits: Optional[int], shift: int, gemm_i32: Callable) -> list:
    """Ring-pipelined ``A @ H`` over dp row ``i``'s sp shards (JAX
    ``_make_ring_agg``): ``blocks[j][k]``, shard ``j``'s adjacency columns of
    shard ``k`` (the left operand of ``gemm_i32``, on shard ``j``'s device);
    ``hs[j]``, shard ``j``'s rows of H. At rotation ``r`` shard ``j`` holds
    shard ``(j - r) % sp``'s hidden and adds ``gemm_i32(blocks[j][src], H)``,
    the raw int32 product (exact whatever the bit width), while the same
    hidden is on its way to shard ``j + 1``: the copies of rotation ``r + 1``
    are issued before the GEMMs of rotation ``r``. After the last rotation:
    requantize (with ``shift``) and split into digits, or float32 for
    ``out_bits`` None. Returns one result per shard."""
    sp = len(hs)
    rows_loc, n = hs[0].shape[0], hs[0].shape[1]
    cur = [h.digits for h in hs]
    ready: List[Optional[torch.cuda.Event]] = [None] * sp
    acc: List[Optional[torch.Tensor]] = [None] * sp
    for r in range(sp):
        nxt = [mesh.send(cur[(j - 1) % sp], i, (j - 1) % sp, j, ready[(j - 1) % sp]) for j in range(sp)] \
            if r < sp - 1 else None
        for j in range(sp):
            h = DigitTensor(digits=Mesh.receive(cur[j], ready[j]), shape=(rows_loc, n), bits=hs[0].bits)
            part = gemm_i32(blocks[j][(j - r) % sp], h)
            acc[j] = part if acc[j] is None else acc[j] + part
        if nxt is not None:
            cur, ready = [t for t, _ in nxt], [e for _, e in nxt]
    if out_bits is None:
        return [a.to(torch.float32) for a in acc]
    return [_levels_to_digits(requantize_wrapped(a, out_bits, shift), out_bits, (rows_loc, n), h.padded_cols)
            for a, h in zip(acc, hs)]


def gather_aggregate(mesh: Mesh, i: int, a_rows: Sequence[DigitTensor], hs: Sequence[DigitTensor],
                     out_bits: Optional[int], shift: int = 0) -> list:
    """``A @ H`` with the whole H gathered on every shard (JAX's
    ``all_gather`` variant, ``sharded.py:365-392``): ``a_rows[j]`` shard
    ``j``'s adjacency rows over every column."""
    out = []
    for j, a in enumerate(a_rows):
        dev = mesh.devices[i][j]
        full = torch.cat([h.digits.to(dev) for h in hs], dim=1)
        h_full = DigitTensor(digits=full, shape=(a.shape[1], hs[0].shape[1]), bits=hs[0].bits)
        out.append(digitmm_to_f32(a, h_full) if out_bits is None
                   else digitmm_to_digits(a, h_full, out_bits, shift=shift))
    return out


def sharded_forward(mesh: Mesh, i: int, hs: List[DigitTensor], ws: Dict[torch.device, List[DigitTensor]],
                    out_bits: int, model: str, agg: Callable, shifts: Optional[Sequence[int]] = None) -> list:
    """One batch's QGCN (update then aggregate) or QGIN (aggregate then
    update, ``main_qgtc.py:131-138``) over dp row ``i``'s sp shards:
    ``hs[j]`` shard ``j``'s feature rows, ``agg(hs, out_bits, shift)`` the
    aggregation, ``shifts`` the per-GEMM requantize shifts in
    ``qgcn_forward`` / ``qgin_forward`` order. Returns each shard's float32
    logits [rows_loc, classes]."""
    if model not in ("gcn", "gin"):
        raise ValueError(model)
    devs = mesh.devices[i]
    n = len(ws[devs[0]])
    sh = iter(list(shifts) if shifts is not None else [0] * (2 * n - 1))

    def update(hs_, l):
        s = next(sh)
        return [digitmm_to_digits(h, ws[d][l], out_bits, shift=s) for h, d in zip(hs_, devs)]

    if model == "gcn":
        for l in range(n):
            hs = update(hs, l)
            if l < n - 1:
                hs = agg(hs, out_bits, next(sh))
        return agg(hs, None, 0)
    hs = agg(hs, out_bits, next(sh))
    for l in range(n - 1):
        hs = update(hs, l)
        hs = agg(hs, out_bits, next(sh))
    return [digitmm_to_f32(h, ws[d][-1]) for h, d in zip(hs, devs)]


def _dense_batch(mesh: Mesh, i: int, a_rows: List[torch.Tensor], x_rows: List[torch.Tensor], ws, out_bits: int,
                 a_bits: int, x_bits: int, x_cols: int, model: str, agg_mode: str) -> list:
    """One batch on dp row ``i``: ``a_rows[j]`` shard ``j``'s digit rows of A
    [nd_a, rows_loc, n], ``x_rows[j]`` its feature digits."""
    sp = len(a_rows)
    rows_loc, n = a_rows[0].shape[1], a_rows[0].shape[2]
    hs = [DigitTensor(digits=x, shape=(rows_loc, x_cols), bits=x_bits) for x in x_rows]
    if agg_mode == "ring":
        # each shard's column blocks, cut once for the batch
        blocks = [[DigitTensor(digits=a[:, :, k * rows_loc:(k + 1) * rows_loc].contiguous(),
                               shape=(rows_loc, rows_loc), bits=a_bits) for k in range(sp)] for a in a_rows]

        def agg(hs_, ob, s):
            return ring_aggregate(mesh, i, blocks, hs_, ob, s, digitmm_to_i32)
    else:
        full = [DigitTensor(digits=a, shape=(rows_loc, n), bits=a_bits) for a in a_rows]

        def agg(hs_, ob, s):
            return gather_aggregate(mesh, i, full, hs_, ob, s)

    return sharded_forward(mesh, i, hs, ws, out_bits, model, agg)


def _check_rows(mesh: Mesh, mp: int) -> int:
    sp = mesh.shape["sp"]
    if mp % (sp * 128):
        raise ValueError(f"padded rows {mp} must divide by sp*128={sp * 128}")
    return mp // sp


def _sp_forward(mesh: Mesh, a: DigitTensor, x: DigitTensor, ws: Weights, out_bits: int, model: str,
                agg_mode: str) -> torch.Tensor:
    _check_rows(mesh, a.padded_rows)
    out = dp_sp_epoch_step(Mesh(mesh.devices[:1]), a.digits[None], x.digits[None], ws, out_bits, a_bits=a.bits,
                           x_bits=x.bits, model=model, agg_mode=agg_mode, x_cols=x.shape[1])
    return out.gather(mesh.devices[0][0])[0][: a.shape[0]]


def sp_gcn_forward(mesh: Mesh, a: DigitTensor, x: DigitTensor, ws: Weights, out_bits: int) -> torch.Tensor:
    """Row-sharded QGCN over the mesh's ``sp`` axis (its first dp row), the
    hidden gathered on every shard at each aggregation. ``a``: (n, n) 1-bit
    digits, ``x``: (n, d) digits, rows sharded; weights on every device.
    Float32 logits [n, classes] on the mesh's first device; the semantics of
    ``models.qmodels.qgcn_forward``."""
    return _sp_forward(mesh, a, x, ws, out_bits, "gcn", "gather")


def sp_gcn_forward_ring(mesh: Mesh, a: DigitTensor, x: DigitTensor, ws: Weights, out_bits: int) -> torch.Tensor:
    """:func:`sp_gcn_forward` with the ring-pipelined aggregation
    (:func:`ring_aggregate`); equal to it bit for bit."""
    return _sp_forward(mesh, a, x, ws, out_bits, "gcn", "ring")


def sp_gin_forward(mesh: Mesh, a: DigitTensor, x: DigitTensor, ws: Weights, out_bits: int) -> torch.Tensor:
    """Row-sharded QGIN (aggregate then update), gathered aggregation."""
    return _sp_forward(mesh, a, x, ws, out_bits, "gin", "gather")


def sp_gin_forward_ring(mesh: Mesh, a: DigitTensor, x: DigitTensor, ws: Weights, out_bits: int) -> torch.Tensor:
    """Row-sharded QGIN with the ring-pipelined aggregation."""
    return _sp_forward(mesh, a, x, ws, out_bits, "gin", "ring")


def dp_sp_epoch_step(
    mesh: Mesh,
    a_stack: Union[torch.Tensor, Sharded],  # [B, nd_a, n, n] int8 digit planes
    x_stack: Union[torch.Tensor, Sharded],  # [B, nd_x, n, d]
    ws: Weights,
    out_bits: int,
    a_bits: int = 1,
    x_bits: int = 2,
    model: str = "gcn",
    agg_mode: str = "ring",
    x_cols: Optional[int] = None,
) -> Sharded:
    """The mesh step over digit planes: batches over ``dp``, rows over
    ``sp``; each aggregation by the ring (``agg_mode='ring'``) or by
    gathering H (``'gather'``). Stacks are CPU tensors (placed here) or
    :func:`shard_batches`' placements; ``B`` must divide by dp. ``x_cols``:
    the features' real columns (default: all of ``d``). Returns the float32 logits [B, n,
    classes], rows on their shards (:meth:`Sharded.gather`)."""
    if model not in ("gcn", "gin"):
        raise ValueError(model)
    if agg_mode not in ("ring", "gather"):
        raise ValueError(agg_mode)
    a_sh = a_stack if isinstance(a_stack, Sharded) else shard_rows(mesh, a_stack)
    x_sh = x_stack if isinstance(x_stack, Sharded) else shard_rows(mesh, x_stack)
    _check_rows(mesh, a_sh.parts[0][0].shape[2] * mesh.shape["sp"])
    xc = x_cols if x_cols is not None else x_sh.parts[0][0].shape[3]
    wsd = replicate(ws, mesh.distinct())
    parts = []
    for i, (a_row, x_row) in enumerate(zip(a_sh.parts, x_sh.parts)):
        outs = [_dense_batch(mesh, i, [a[b] for a in a_row], [x[b] for x in x_row], wsd, out_bits, a_bits, x_bits,
                             xc, model, agg_mode) for b in range(a_row[0].shape[0])]
        parts.append(tuple(torch.stack([o[j] for o in outs]) for j in range(len(a_row))))
    return Sharded(tuple(parts), 1)
