"""Probe: where each byte of an int32 word lands, on the card (port of
``benchmarks/exp_bitcast_probe.py``).

The packed kernels unpack int32 words byte by byte, and their ``mma.sync``
fragments are 32-bit loads of four int8 values: both rest on byte order.
Three tables, each from a hand-written kernel (``csrc/exp_bitcast_probe.cu``)
held to its plain PyTorch version:

* :func:`bitcast32to8`: int32 [M, N] -> int8 [4M, N], byte k of word row
  i to row 4i + k, as ``pltpu.bitcast`` gives in interpret mode (on the
  card's memory this is a transpose of each word's 4 bytes, not a view);
* :func:`bitcast8to32`: the inverse, word i = bytes 4i .. 4i+3,
  little-endian (a thread takes four columns of one word row: four 4-byte
  loads, one 16-byte store);
* :func:`fragment_registers`: the registers of the first
  ``mma.sync.m16n8k32`` s8 of warp 0, the A tile staged by ``Int8Loader``
  and B transposed by ``load_b`` (both in ``csrc/exp_bitcast_probe.cu``),
  loaded by ``gemm_core.cuh``'s 32-bit shared-memory loads ``frag_a`` and
  ``frag_b``, which K2's K loop calls (``frag_b`` K3's too);
  :func:`fragment_table` decodes which (row, k) of the A tile and which
  (k, n) of B each byte holds and compares them with the PTX ISA's layout
  for that shape (:func:`fragment_registers_plain`).

CPU tensors run the plain versions; CUDA tensors launch the kernels
(``TO8_LAUNCHES``, ``TO32_LAUNCHES``, ``FRAGMENT_LAUNCHES``) or raise.

Usage (needs a CUDA device)::

    python -m qgtc_ppopp22_tpu_torch.benchmarks.exp_bitcast_probe
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.ops import _gemm
from qgtc_ppopp22_tpu_torch.ops._build import check, library
from qgtc_ppopp22_tpu_torch.ops.bitpack import u32_to_i32

TILE = 64  # the fragment probe's A tile [64 x 64] (rows x k) and B [64 x 64] (k x n)

TO8_LAUNCHES = 0  # csrc/exp_bitcast_probe.cu bitcast32to8 launches since the count was last reset to 0
TO32_LAUNCHES = 0  # its bitcast8to32 launches, likewise
FRAGMENT_LAUNCHES = 0  # its fragment_probe launches, likewise


def bitcast32to8_plain(x: torch.Tensor) -> torch.Tensor:
    """int32 [M, N] -> int8 [4M, N]: row 4i + k holds byte k of word row
    i (bits 8k .. 8k + 7)."""
    _check_dtype(x, torch.int32)
    M, N = x.shape
    k = torch.arange(4, device=x.device).reshape(1, 4, 1)
    byte = (x.to(torch.int64)[:, None, :] >> (8 * k)) & 0xFF
    return (byte - 256 * (byte >= 128).to(torch.int64)).to(torch.int8).reshape(4 * M, N)


def bitcast8to32_plain(x: torch.Tensor) -> torch.Tensor:
    """int8 [4M, N] -> int32 [M, N]: word i = bytes 4i .. 4i + 3 of its
    column, little-endian."""
    _check_dtype(x, torch.int8)
    if x.shape[0] % 4:
        raise ValueError(f"bitcast8to32 needs a multiple of 4 rows, got {x.shape[0]}")
    byte = (x.to(torch.int64) & 0xFF).reshape(x.shape[0] // 4, 4, x.shape[1])
    k = torch.arange(4, device=x.device).reshape(1, 4, 1)
    return u32_to_i32((byte << (8 * k)).sum(dim=1))


def _check_dtype(x: torch.Tensor, dtype) -> None:
    if x.dtype != dtype or x.dim() != 2:
        raise TypeError(f"expected a 2-D {dtype} tensor, got {x.dtype} of shape {tuple(x.shape)}")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def bitcast32to8(x: torch.Tensor) -> torch.Tensor:
    """The card's kernel for :func:`bitcast32to8_plain` (CPU: the plain version)."""
    global TO8_LAUNCHES
    if not x.is_cuda:
        return bitcast32to8_plain(x)
    _check_dtype(x, torch.int32)
    M, N = x.shape
    out = torch.empty((4 * M, N), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        err = library().qgtc_bitcast32to8(out.data_ptr(), _gemm._operand(x, torch.int32, "x"), M, N,
                                          _stream(x))
    check(err, "qgtc_bitcast32to8")
    TO8_LAUNCHES += 1
    return out


def bitcast8to32(x: torch.Tensor) -> torch.Tensor:
    """The card's kernel for :func:`bitcast8to32_plain` (CPU: the plain version)."""
    global TO32_LAUNCHES
    if not x.is_cuda:
        return bitcast8to32_plain(x)
    _check_dtype(x, torch.int8)
    if x.shape[0] % 4:
        raise ValueError(f"bitcast8to32 needs a multiple of 4 rows, got {x.shape[0]}")
    M, N = x.shape[0] // 4, x.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = library().qgtc_bitcast8to32(out.data_ptr(), _gemm._operand(x, torch.int8, "x"), M, N,
                                          _stream(x))
    check(err, "qgtc_bitcast8to32")
    TO32_LAUNCHES += 1
    return out


def _fragment_tiles(a_tile: torch.Tensor, b_tile: torch.Tensor) -> None:
    for t, name in ((a_tile, "a_tile"), (b_tile, "b_tile")):
        if t.dtype != torch.int8 or tuple(t.shape) != (TILE, TILE):
            raise ValueError(f"{name}: expected int8 [{TILE}, {TILE}], got {t.dtype} {tuple(t.shape)}")
    if a_tile.device != b_tile.device:
        raise ValueError(f"tiles on {a_tile.device} and {b_tile.device}")


def ptx_layout() -> Tuple[np.ndarray, np.ndarray]:
    """The PTX ISA's fragment layout of ``mma.m16n8k32`` with .s8 A
    (row-major) and B (column-major): for lane l = 4 * groupID +
    threadID_in_group, register r and byte j, A's (row, k) [32, 4, 4, 2]
    and B's (k, n) [32, 2, 4, 2]. A: a_i, i = 4r + j, sits at row
    groupID (+ 8 when 4 <= i < 8 or i >= 12) and column 4 *
    threadID_in_group + (i & 3) (+ 16 when i >= 8); B: b_i, i = 4r + j, at
    row 4 * threadID_in_group + (i & 3) (+ 16 when i >= 4), column
    groupID."""
    lane, reg, byte = np.meshgrid(np.arange(32), np.arange(4), np.arange(4), indexing="ij")
    g, t4 = lane >> 2, lane & 3
    a = np.stack([g + 8 * (reg & 1), 4 * t4 + byte + 16 * (reg >> 1)], axis=-1)
    lane, reg, byte = np.meshgrid(np.arange(32), np.arange(2), np.arange(4), indexing="ij")
    b = np.stack([4 * (lane & 3) + byte + 16 * reg, lane >> 2], axis=-1)
    return a, b


def fragment_registers_plain(a_tile: torch.Tensor, b_tile: torch.Tensor):
    """The fragment registers per the PTX ISA layout (:func:`ptx_layout`):
    (A's int32 [32, 4], B's int32 [32, 2]), byte j of a register in bits
    8j .. 8j + 7."""
    _fragment_tiles(a_tile, b_tile)
    la, lb = (torch.as_tensor(t, device=a_tile.device) for t in ptx_layout())
    a = a_tile.to(torch.int64)[la[..., 0], la[..., 1]] & 0xFF
    b = b_tile.to(torch.int64)[lb[..., 0], lb[..., 1]] & 0xFF
    shift = 8 * torch.arange(4, device=a_tile.device)
    return u32_to_i32((a << shift).sum(dim=-1)), u32_to_i32((b << shift).sum(dim=-1))


def fragment_registers(a_tile: torch.Tensor, b_tile: torch.Tensor):
    """Warp 0's first fragments as ``gemm_core.cuh`` stages and loads them,
    from an A tile int8 [64, 64] (rows x k) and a B tile int8 [64, 64] (k
    x n): (A's int32 [32, 4], B's int32 [32, 2]) per lane. CPU: the plain
    version."""
    global FRAGMENT_LAUNCHES
    if not a_tile.is_cuda:
        return fragment_registers_plain(a_tile, b_tile)
    _fragment_tiles(a_tile, b_tile)
    a_regs = torch.empty((32, 4), dtype=torch.int32, device=a_tile.device)
    b_regs = torch.empty((32, 2), dtype=torch.int32, device=a_tile.device)
    with torch.cuda.device(a_tile.device):
        err = library().qgtc_fragment_probe(a_regs.data_ptr(), b_regs.data_ptr(),
                                            _gemm._operand(a_tile, torch.int8, "a_tile"),
                                            _gemm._operand(b_tile, torch.int8, "b_tile"), _stream(a_tile))
    check(err, "qgtc_fragment_probe")
    FRAGMENT_LAUNCHES += 1
    return a_regs, b_regs


def _bytes(regs: torch.Tensor) -> np.ndarray:
    """int32 registers [..., r] -> their bytes [..., r, 4], byte j = bits 8j.."""
    v = regs.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    return (v[..., None] >> (8 * np.arange(4))) & 0xFF


def fragment_table(device) -> Tuple[np.ndarray, np.ndarray]:
    """Which (row, k) of the A tile and (k, n) of the B tile each byte of
    each lane's registers holds, through :func:`fragment_registers` (two
    calls: tiles of row and k indices, then of k and n indices). Returns
    (A [32, 4, 4, 2], B [32, 2, 4, 2])."""
    idx = torch.arange(TILE, dtype=torch.int8, device=device)
    rows, cols = idx[:, None].expand(TILE, TILE).contiguous(), idx[None, :].expand(TILE, TILE).contiguous()
    a_row, b_k = fragment_registers(rows, rows)
    a_k, b_n = fragment_registers(cols, cols)
    return (np.stack([_bytes(a_row), _bytes(a_k)], axis=-1),
            np.stack([_bytes(b_k), _bytes(b_n)], axis=-1))


def _span(pairs: np.ndarray, vary: int) -> str:
    """A register's 4 (x, y) pairs, as '(x, y0-y3)' when only index
    ``vary`` runs through 4 consecutive values."""
    fixed = 1 - vary
    if (pairs[:, fixed] == pairs[0, fixed]).all() and (np.diff(pairs[:, vary]) == 1).all():
        lo, hi = pairs[0, vary], pairs[-1, vary]
        return f"({pairs[0, 0]}, {lo}-{hi})" if vary else f"({lo}-{hi}, {pairs[0, 1]})"
    return " ".join(f"({x}, {y})" for x, y in pairs)


def probe32to8(device="cuda") -> torch.Tensor:
    """JAX's probe32to8 on ``device``: prints column 0 of the output for
    word i = bytes 4i .. 4i+3 (values 4i + k) and checks lane invariance."""
    M, N = 8, 128
    words = np.zeros((M, N), np.uint32)
    for i in range(M):
        for k in range(4):
            words[i, :] |= np.uint32((i * 4 + k) << (8 * k))
    out = bitcast32to8(torch.from_numpy(words.view(np.int32)).to(device)).cpu().numpy()
    print("int32->int8 bitcast: out[r,0] for r in range(32):")
    print(out[:, 0].tolist())
    assert (out == out[:, :1]).all(), "lane-dependent?!"
    return out


def probe8to32(device="cuda") -> np.ndarray:
    """JAX's probe8to32 on ``device``: prints column 0 of the words made
    from rows of bytes 0 .. 31, in hex."""
    M, N = 32, 128
    b = np.arange(M, dtype=np.uint8)[:, None] * np.ones((1, N), np.uint8)
    out = bitcast8to32(torch.from_numpy(b.view(np.int8)).to(device)).cpu().numpy().view(np.uint32)
    print("int8->int32 bitcast: hex words out[:,0]:")
    print([hex(v) for v in out[:, 0].tolist()])
    return out


def probe_fragments(device="cuda") -> bool:
    """Prints the fragment table, one line per lane, and whether it is the
    PTX ISA's layout; returns that."""
    got_a, got_b = fragment_table(device)
    want_a, want_b = ptx_layout()
    same = bool(np.array_equal(got_a, want_a) and np.array_equal(got_b, want_b))
    print("mma.sync.m16n8k32 s8 fragments through gemm_core.cuh's shared-memory loads, "
          "each register's 4 bytes as A (row, k) | B (k, n):")
    for lane in range(32):
        a = " ".join(f"a{r} {_span(got_a[lane, r], 1)}" for r in range(4))
        b = " ".join(f"b{r} {_span(got_b[lane, r], 0)}" for r in range(2))
        print(f"lane {lane:2d}: {a} | {b}")
    print(f"the PTX ISA layout: {same}")
    return same


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("exp_bitcast_probe runs the card's kernels and needs a CUDA device")
    from qgtc_ppopp22_tpu_torch.benchmarks.gemm_times import card_line

    print(f"card: {card_line()}")
    probe32to8("cuda")
    probe8to32("cuda")
    return 0 if probe_fragments("cuda") else 1


if __name__ == "__main__":
    sys.exit(main())
