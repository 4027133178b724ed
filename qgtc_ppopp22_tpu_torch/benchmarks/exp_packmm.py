"""Experiment: the packed-A GEMM's unpack, on the card (port of
``benchmarks/exp_packmm.py``).

A is bit-packed along M into int32 words: logical row ``q*(4*ms) + 4*i +
k`` of an M-tile of ``tm`` rows lives in bits ``8k + f*q ..`` of word row
``i`` (f = field bits, P = 8/f fields per byte, ms = tm / (32/f)). The
port's ``ops/packmm`` layout is the ``tm = 256`` case. Two products over
it, each a hand-written kernel (``csrc/exp_packmm.cuh``) with a plain
PyTorch version:

* :func:`packmm_exp`: words x int8 B -> float32 A.B, in five variants
  (``VARIANTS``: concat, slabs, noextract, bres, bres_chunk; the JAX
  script's names, the card's mechanisms, in the kernel's source),
  :func:`packmm_exp_int8`, the same product with an int8 A, and
  :func:`packmm_exp_k2loader`, concat with K2's own A loader;
* :func:`packmm_exp_packedout`: the requantized product repacked in A's
  layout, per ``group`` rows (the reference's ``bitMM2Bit_profile`` op).

The card's question: what one 64-deep K step of ``gemm_core.cuh``'s loop
spends on the unpack of A, on staging it in shared memory and on the
MMAs. :func:`ladder` times every variant on one K loop beside K2
(``packmm_to_f32``) and ``torch._int_mm`` on the unpacked operands, and
reports us per call, us per K step and TFLOP/s (``2*M*N*K``).

Dispatch: CPU tensors run the plain versions; CUDA tensors launch the
kernel (``LAUNCHES``, ``PACKEDOUT_LAUNCHES``) or raise. ``tk`` (a TPU
block size) is accepted and unused: the kernel's K step is 64.

Usage (needs a CUDA device)::

    python -m qgtc_ppopp22_tpu_torch.benchmarks.exp_packmm [--csv out.csv] [--iters 20]
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from qgtc_ppopp22_tpu_torch.ops import _gemm
from qgtc_ppopp22_tpu_torch.ops._build import check, library
from qgtc_ppopp22_tpu_torch.ops.bitgemm import flops_convention
from qgtc_ppopp22_tpu_torch.ops.bitpack import round_up, u32_to_i32
from qgtc_ppopp22_tpu_torch.ops.quantize import requantize_wrapped

VARIANTS = ("concat", "slabs", "noextract", "bres", "bres_chunk")
_CODE = {"concat": 0, "slabs": 1, "noextract": 2, "bres": 3, "bres_chunk": 4, "int8": 5,
         "k2loader": 6}  # csrc Variant
K_STEP = 64  # the kernel's K step (csrc/gemm_core.cuh BK)
_SMEM_LIMIT = 227 * 1024  # an H100 CTA's shared memory
# The per-K-step ladder: (M = K, N, bits); C1's aggregation first
C1_SHAPE = (2560, 16, 1)
LADDER_SHAPES = (C1_SHAPE,) + tuple((4096, n, b) for n in (16, 64) for b in (1, 2, 4))
# The JAX script's run_packedout rows (:318-331): M, K, N, bits, tm, tk, group
PACKEDOUT_ROWS = (
    (4096, 4096, 16, 1, 4096, 4096, 0), (4096, 4096, 16, 1, 2048, 4096, 0),
    (4096, 4096, 16, 1, 4096, 4096, 256), (4096, 4096, 16, 1, 4096, 4096, 512),
    (4096, 4096, 16, 1, 2048, 2048, 0), (2048, 2048, 16, 1, 2048, 2048, 0),
    (2048, 2048, 16, 1, 2048, 2048, 256), (1024, 1024, 16, 1, 1024, 1024, 0),
    (4096, 4096, 16, 2, 4096, 4096, 256), (4096, 4096, 64, 1, 4096, 4096, 256),
)

LAUNCHES = 0  # csrc/exp_packmm.cu float-out launches since the count was last reset to 0
PACKEDOUT_LAUNCHES = 0  # its packed-out launches, likewise


def field_bits(bits: int) -> int:
    for f in (1, 2, 4):
        if bits <= f:
            return f
    return 8  # no packing


def pack_rows_np(q: np.ndarray, bits: int, tile_m: int) -> np.ndarray:
    """int levels (Mp, Kp) -> int32 words [Mp // (32/f), Kp], permuted
    per M-tile so in-kernel extraction lands rows in order."""
    f = field_bits(bits)
    assert f < 8
    P = 8 // f
    rpw = 32 // f  # rows per word
    Mp, Kp = q.shape
    assert Mp % tile_m == 0 and tile_m % rpw == 0
    ms = tile_m // rpw
    words = np.zeros((Mp // rpw, Kp), np.uint32)
    vals = q.astype(np.uint32) & np.uint32((1 << f) - 1)
    for t in range(Mp // tile_m):
        for qf in range(P):
            for k in range(4):
                # rows r = t*tile_m + qf*(4*ms) + 4*i + k, i in [0, ms)
                rows = vals[
                    t * tile_m + qf * 4 * ms + k : t * tile_m + (qf + 1) * 4 * ms : 4,
                    :,
                ]
                words[t * ms : (t + 1) * ms, :] |= rows << np.uint32(8 * k + f * qf)
    return words.view(np.int32)


def unpack_rows_np(words: np.ndarray, bits: int, tile_m: int) -> np.ndarray:
    f = field_bits(bits)
    P = 8 // f
    rpw = 32 // f
    mw, Kp = words.shape
    Mp = mw * rpw
    w = words.view(np.uint32)
    ms = tile_m // rpw
    out = np.zeros((Mp, Kp), np.int32)
    for t in range(Mp // tile_m):
        for qf in range(P):
            for k in range(4):
                rows = (w[t * ms:(t + 1) * ms, :] >> np.uint32(8 * k + f * qf)) \
                    & np.uint32((1 << f) - 1)
                out[t * tile_m + qf * 4 * ms + k:
                    t * tile_m + (qf + 1) * 4 * ms:4, :] = rows
    return out


# -- the layout in torch, on any device ----------------------------------

def _slot_shifts(f: int, device) -> torch.Tensor:
    """Bit offset ``8k + f*q`` of slot (q, k), shaped [1, P, 1, 4, 1]."""
    q, k = np.meshgrid(np.arange(8 // f), np.arange(4), indexing="ij")
    return torch.as_tensor(8 * k + f * q, dtype=torch.int64, device=device)[None, :, None, :, None]


def _word_slots(words: torch.Tensor, f: int, tm: int) -> torch.Tensor:
    """int32 words [mw, C] -> their unsigned values as int64 [T, 1, ms, 1, C]."""
    ms = tm // (32 // f)
    mw, C = words.shape
    return (words.to(torch.int64) & 0xFFFFFFFF).reshape(mw // ms, 1, ms, 1, C)


def unpack_levels(words: torch.Tensor, bits: int, tm: int) -> torch.Tensor:
    """int32 words [mw, C] in the layout of tile ``tm`` -> int64 levels
    [mw * 32/f, C] in logical row order."""
    f = field_bits(bits)
    w = _word_slots(words, f, tm)
    return ((w >> _slot_shifts(f, words.device)) & ((1 << f) - 1)).reshape(-1, words.shape[1])


def noextract_levels(words: torch.Tensor, bits: int, tm: int) -> torch.Tensor:
    """The ablation's A: logical row ``q*4*ms + 4*i + k`` is byte k of
    word row i, as a signed int8, for every field q (the JAX variant's
    int8 bitcast of the words, repeated P times)."""
    f = field_bits(bits)
    w = _word_slots(words, f, tm)
    k = torch.arange(4, device=words.device).reshape(1, 1, 1, 4, 1)
    byte = (w >> (8 * k)) & 0xFF
    byte = byte - 256 * (byte >= 128).to(torch.int64)
    return byte.expand(-1, 8 // f, -1, -1, -1).reshape(-1, words.shape[1])


def pack_levels(levels: torch.Tensor, bits: int, tm: int) -> torch.Tensor:
    """int levels [Mp, C] in [0, 2^f) -> int32 words [Mp / (32/f), C] in
    the layout of tile ``tm`` (the inverse of :func:`unpack_levels`)."""
    f = field_bits(bits)
    P, rpw = 8 // f, 32 // f
    ms = tm // rpw
    Mp, C = levels.shape
    slots = levels.to(torch.int64).reshape(Mp // tm, P, ms, 4, C) << _slot_shifts(f, levels.device)
    return u32_to_i32(slots.sum(dim=(1, 3)).reshape(Mp // rpw, C))


# -- the products ----------------------------------------------------------

def _shapes(words: torch.Tensor, b: torch.Tensor, bits: int, tm: int):
    """Check JAX's contract (words [1, Mp/rpw, Kp] int32 in the layout of
    tile tm, B [1, Kp, Np] int8; Mp % tm == 0, tm % rpw == 0) ->
    (f, Mp, Kp, Np)."""
    if not 1 <= bits <= 4:
        raise ValueError(f"the packed probe takes 1-4 bit levels, got {bits}")
    f = field_bits(bits)
    rpw = 32 // f
    if words.dtype != torch.int32 or b.dtype != torch.int8:
        raise TypeError(f"expected int32 words and int8 B, got {words.dtype} and {b.dtype}")
    if words.dim() != 3 or words.shape[0] != 1 or b.dim() != 3 or b.shape[0] != 1:
        raise ValueError(f"expected words [1, Mp/rpw, Kp] and B [1, Kp, Np], got "
                         f"{tuple(words.shape)} and {tuple(b.shape)}")
    Mp, Kp, Np = words.shape[1] * rpw, words.shape[2], b.shape[2]
    if b.shape[1] != Kp:
        raise ValueError(f"words have {Kp} columns, B {b.shape[1]} rows")
    if tm <= 0 or Mp % tm or tm % rpw:
        raise ValueError(f"tile tm={tm} must divide Mp={Mp} and be a multiple of {rpw}")
    if b.device != words.device:
        raise ValueError(f"operands on {words.device} and {b.device}")
    return f, Mp, Kp, Np


def _wrap_i32(acc: torch.Tensor) -> torch.Tensor:
    """An exact int64 sum -> the int32 the kernel's accumulator holds."""
    return u32_to_i32(acc & 0xFFFFFFFF)


def packmm_exp_plain(words: torch.Tensor, b: torch.Tensor, bits: int, tm: int,
                     variant: str = "concat", tk: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`packmm_exp`: float32 [Mp, Np]."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")
    _shapes(words, b, bits, tm)
    lv = noextract_levels(words[0], bits, tm) if variant == "noextract" else unpack_levels(words[0], bits, tm)
    return _wrap_i32(_gemm.plain_product(lv, b[0])).to(torch.float32)


def packmm_exp_int8_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`packmm_exp_int8`: float32 [Mp, Np]."""
    _int8_shapes(a, b)
    return _wrap_i32(_gemm.plain_product(a[0], b[0])).to(torch.float32)


def packmm_exp_packedout_plain(words: torch.Tensor, b: torch.Tensor, bits: int, tm: int,
                               group: int = 0, tk: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`packmm_exp_packedout`: int32 words
    [1, Mp / rpw, Np]."""
    g = group or tm
    _shapes(words, b, bits, g)
    acc = _wrap_i32(_gemm.plain_product(unpack_levels(words[0], bits, g), b[0]))
    return pack_levels(requantize_wrapped(acc.to(torch.int64), bits, 0), bits, g)[None]


def _int8_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"expected int8 A and B, got {a.dtype} and {b.dtype}")
    if a.dim() != 3 or a.shape[0] != 1 or b.dim() != 3 or b.shape[0] != 1 or a.shape[2] != b.shape[1]:
        raise ValueError(f"expected A [1, Mp, Kp] and B [1, Kp, Np], got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"operands on {a.device} and {b.device}")


def _kernel_shapes(Mp: int, Kp: int, Np: int, tm: Optional[int], variant: str) -> None:
    """What the kernel indexes beyond JAX's contract: a K step of 64, a
    column tile of 16 or 64, 64-row CTAs inside one layout tile, and a
    resident B that fits in shared memory."""
    if Mp % 64 or Kp % K_STEP or Np % 16 or (tm is not None and tm % 256):
        raise ValueError(f"the kernel needs Mp % 64, Kp % {K_STEP}, Np % 16 and tm % 256 to be 0, "
                         f"got Mp={Mp} Kp={Kp} Np={Np} tm={tm}")
    if variant.startswith("bres") and not bres_fits(Kp, Np):
        raise ValueError(f"{variant}: B [{Kp} x {bres_tile(Np)}] does not fit in shared memory")


def bres_tile(np_: int) -> int:
    """The kernel's column tile for a B of ``np_`` columns."""
    return 64 if np_ % 64 == 0 else 16


def bres_fits(kp: int, np_: int) -> bool:
    """Whether a CTA's columns of B fit in shared memory whole (bres)."""
    return bres_tile(np_) * (kp + 16) + 2 * 64 * 80 <= _SMEM_LIMIT


def _launch(out, a, b, variant: str, f: int, Mp: int, Kp: int, Np: int, tm: int, out_bits: int):
    lib = library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.qgtc_exp_packmm(out.data_ptr(), _gemm._operand(a, a.dtype, "A"),
                                  _gemm._operand(b, torch.int8, "B"), _CODE[variant], f, Mp, Kp, Np,
                                  tm, out_bits, stream)
    check(err, f"qgtc_exp_packmm({variant})")
    return out


def packmm_exp(words: torch.Tensor, b: torch.Tensor, bits: int, tm: int, variant: str = "concat",
               tk: Optional[int] = None) -> torch.Tensor:
    """words int32 [1, Mp/rpw, Kp] (layout tile ``tm``) x B int8 [1, Kp,
    Np] -> float32 [Mp, Np] = A.B exactly (``noextract``: its ablation's
    product, see :func:`noextract_levels`)."""
    global LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")
    if not words.is_cuda:
        return packmm_exp_plain(words, b, bits, tm, variant)
    f, Mp, Kp, Np = _shapes(words, b, bits, tm)
    _kernel_shapes(Mp, Kp, Np, tm, variant)
    out = torch.empty((Mp, Np), dtype=torch.float32, device=words.device)
    _launch(out, words, b, variant, f, Mp, Kp, Np, tm, 0)
    LAUNCHES += 1
    return out


def packmm_exp_int8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An int8 A [1, Mp, Kp] x B int8 [1, Kp, Np] -> float32 [Mp, Np]: the
    probe's K loop with A staged by ``gemm_core.cuh``'s ``Int8Loader``."""
    global LAUNCHES
    if not a.is_cuda:
        return packmm_exp_int8_plain(a, b)
    _int8_shapes(a, b)
    Mp, Kp, Np = a.shape[1], a.shape[2], b.shape[2]
    _kernel_shapes(Mp, Kp, Np, None, "int8")
    out = torch.empty((Mp, Np), dtype=torch.float32, device=a.device)
    _launch(out, a, b, "int8", 8, Mp, Kp, Np, 0, 0)
    LAUNCHES += 1
    return out


def packmm_exp_packedout(words: torch.Tensor, b: torch.Tensor, bits: int, tm: int, group: int = 0,
                         tk: Optional[int] = None) -> torch.Tensor:
    """words (layout tile ``group or tm``) x B -> the requantized product
    ``r = acc > 2^b ? 2^b - 1 : (acc < 0 ? 1 : acc)``, ``r & (2^b - 1)``,
    repacked per ``group`` rows (0: per ``tm``): int32 [1, Mp/rpw, Np].
    On the card the layout tile is all that ``tm`` and ``group`` set."""
    global PACKEDOUT_LAUNCHES
    if not words.is_cuda:
        return packmm_exp_packedout_plain(words, b, bits, tm, group)
    g = group or tm
    f, Mp, Kp, Np = _shapes(words, b, bits, g)
    _kernel_shapes(Mp, Kp, Np, g, "concat")
    out = torch.zeros((1, Mp // (32 // f), Np), dtype=torch.int32, device=words.device)
    _launch(out, words, b, "concat", f, Mp, Kp, Np, g, bits)
    PACKEDOUT_LAUNCHES += 1
    return out


def packmm_exp_k2loader(words: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """:func:`packmm_exp`'s concat with A staged by ``gemm_core.cuh``'s
    ``PackedLoader``, which computes each row's word address and shift
    every K step where concat computes them once: the port's ``tm = 256``
    layout only. The same product (plain: ``packmm_exp_plain(words, b,
    bits, 256)``)."""
    global LAUNCHES
    if not words.is_cuda:
        return packmm_exp_plain(words, b, bits, 256)
    f, Mp, Kp, Np = _shapes(words, b, bits, 256)
    _kernel_shapes(Mp, Kp, Np, 256, "k2loader")
    out = torch.empty((Mp, Np), dtype=torch.float32, device=words.device)
    _launch(out, words, b, "k2loader", f, Mp, Kp, Np, 256, 0)
    LAUNCHES += 1
    return out


# -- the studies (CUDA) ------------------------------------------------------

def operands(M: int, K: int, N: int, bits: int, rng, device, np_: Optional[int] = None):
    """JAX ``run_shape``'s draws (A levels, then B levels) -> (qa, qb, B
    int8 [1, K, np_] zero-padded; np_ = N rounded up to 16)."""
    qa = rng.integers(0, 1 << bits, (M, K)).astype(np.int32)
    qb = rng.integers(0, 1 << bits, (K, N)).astype(np.int32)
    b = np.zeros((1, K, np_ or round_up(N, 16)), np.int8)
    b[0, :, :N] = qb
    return qa, qb, torch.from_numpy(b).to(device)


def _time_ms(fns: Dict, iters: int) -> Dict:
    from qgtc_ppopp22_tpu_torch.utils.timing import device_times_ms

    return device_times_ms(fns, iters=iters)


def run_packedout(M: int, K: int, N: int, bits: int, tm: int, tk: int, rng, group: int = 0,
                  iters: int = 20, device="cuda") -> Dict:
    """One of JAX's ``run_packedout`` rows on the card: the kernel's
    output, unpacked, must equal the NumPy requantized product (raises
    ``AssertionError`` if not); then its device time."""
    g = group or tm
    qa, qb, b = operands(M, K, N, bits, rng, device)
    words = torch.from_numpy(pack_rows_np(qa, bits, g)[None]).to(device)
    out = packmm_exp_packedout(words, b, bits, tm, group, tk)
    ub = 1 << bits
    ref = (qa.astype(np.float64) @ qb).astype(np.int64)  # exact: far below 2^53
    ref = np.where(ref > ub, ub - 1, np.where(ref < 0, 1, ref)) & (ub - 1)
    got = unpack_rows_np(out[0].cpu().numpy(), bits, g)[:M, :N]
    if not np.array_equal(got.astype(np.int64), ref):
        raise AssertionError(f"packedout bits={bits} M=K={M} N={N} tm={tm} g={g}: inexact")
    t = _time_ms({0: lambda: packmm_exp_packedout(words, b, bits, tm, group, tk)}, iters)[0] * 1e-3
    return dict(probe="packedout", bits=bits, M=M, K=K, N=N, tm=tm, g=g, us=t * 1e6,
                tflops=flops_convention(M, N, K) / t / 1e12, exact=True)


def ladder_calls(mk: int, n: int, bits: int, rng, device) -> List[tuple]:
    """The ladder's rows at M = K = ``mk``: (name, call, want), ``want``
    the output the call must equal. ``bres`` and ``bres_chunk`` run where
    a CTA's columns of B fit in shared memory (not at 4096 x 64)."""
    from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack
    from qgtc_ppopp22_tpu_torch.ops.packmm import PackedTensor, packmm_to_f32

    qa, qb, b = operands(mk, mk, n, bits, rng, device)
    tm = 256  # the port's packmm layout
    words = torch.from_numpy(pack_rows_np(qa, bits, tm)[None]).to(device)
    a8 = torch.from_numpy(qa.astype(np.int8)[None]).to(device)
    ref = packmm_exp_plain(words, b, bits, tm)
    rows = [(v, lambda v=v: packmm_exp(words, b, bits, tm, v),
             packmm_exp_plain(words, b, bits, tm, v) if v == "noextract" else ref)
            for v in VARIANTS if not v.startswith("bres") or bres_fits(mk, b.shape[2])]
    rows.append(("int8", lambda: packmm_exp_int8(a8, b), ref))
    # on the 64-column tile K2 uses: concat, then concat with K2's loader
    # (the address math of every step, alone)
    b64, ref64 = b, ref
    if b.shape[2] % 64:
        b64 = torch.zeros((1, mk, 64), dtype=torch.int8, device=device)
        b64[..., :b.shape[2]] = b
        ref64 = torch.nn.functional.pad(ref, (0, 64 - b.shape[2]))
        rows.append(("concat, 64-column tile", lambda: packmm_exp(words, b64, bits, tm), ref64))
    rows.append(("concat with K2's loader, 64-column tile", lambda: packmm_exp_k2loader(words, b64, bits), ref64))
    k2a = PackedTensor(words=words, shape=(mk, mk), bits=bits)
    k2b = digit_pack(torch.from_numpy(qb).to(device), bits)
    rows.append(("K2 packmm_to_f32", lambda: packmm_to_f32(k2a, k2b), ref[:, :n]))
    ia, ib = torch.from_numpy(qa.astype(np.int8)).to(device), torch.from_numpy(qb.astype(np.int8)).to(device)
    rows.append(("torch._int_mm", lambda: torch._int_mm(ia, ib), ref[:, :n].to(torch.int32)))
    return rows


def ladder(shapes=LADDER_SHAPES, iters: int = 20, rng=None, device="cuda") -> List[Dict]:
    """The per-K-step ladder on the card: each row's output checked
    against its plain version first (``AssertionError`` if not equal),
    then every row of a shape timed in one profiler session."""
    rng = np.random.default_rng(0) if rng is None else rng
    out = []
    for mk, n, bits in shapes:
        calls = ladder_calls(mk, n, bits, rng, device)
        for name, run, want in calls:
            if not torch.equal(run(), want):
                raise AssertionError(f"ladder M=K={mk} N={n} bits={bits} {name}: != plain")
        ms = _time_ms({name: run for name, run, _ in calls}, iters)
        for name, _, _ in calls:
            t = ms[name] * 1e-3
            out.append(dict(probe="ladder", bits=bits, M=mk, K=mk, N=n, row=name, us=t * 1e6,
                            us_per_step=t * 1e6 / (mk // K_STEP),
                            tflops=flops_convention(mk, n, mk) / t / 1e12))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--csv", type=str, default=None)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exp_packmm times the card's kernels and needs a CUDA device")
    from qgtc_ppopp22_tpu_torch.benchmarks.gemm_times import card_line

    print(f"card: {card_line()}", flush=True)
    rng = np.random.default_rng(0)
    rows = []
    for M, K, N, bits, tm, tk, group in PACKEDOUT_ROWS:
        r = run_packedout(M, K, N, bits, tm, tk, rng, group, args.iters)
        print(f"PACKEDOUT bits={bits} M=K={M} N={N} tm={tm} tk={tk} g={r['g']}: "
              f"{r['us']:.2f} us, {r['tflops']:.2f} TFLOPs exact={r['exact']}", flush=True)
        rows.append(r)
    for r in ladder(iters=args.iters):
        print(f"ladder bits={r['bits']} M=K={r['M']} N={r['N']} {r['row']}: {r['us']:.2f} us, "
              f"{r['us_per_step']:.3f} us per {K_STEP}-deep K step, {r['tflops']:.3f} TFLOP/s", flush=True)
        rows.append(r)
    if args.csv:
        from qgtc_ppopp22_tpu_torch.utils.metrics import write_csv

        write_csv(args.csv, rows, sorted({k for r in rows for k in r}))
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
