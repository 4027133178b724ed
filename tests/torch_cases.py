"""GEMM test operands shared by the port's CPU and CUDA tests (no jax)."""

import numpy as np


def linear_density(k, a_bits, b_bits, out_bits, shift):
    """A density whose expected accumulator is about 2^out_bits << shift,
    so the requantizer sees values on both sides of its clamp instead of
    saturating."""
    mean = ((1 << a_bits) - 1) / 2 * ((1 << b_bits) - 1) / 2
    return float(min(1.0, ((1 << out_bits) << shift) / (k * mean)))


def operands(seed, m, k, n, a_bits, b_bits, out_bits, shift):
    """Random, asymmetric, non-banded levels A (m x k) and B (k x n)."""
    rng = np.random.default_rng(seed)
    qa = rng.integers(0, 1 << a_bits, (m, k))
    qa *= rng.random((m, k)) < linear_density(k, a_bits, b_bits, out_bits, shift)
    qb = rng.integers(0, 1 << b_bits, (k, n))
    return qa.astype(np.int32), qb.astype(np.int32)


def edge_operands(bits, shift):
    """Row i of A @ B is i in column 0 for i < span =
    (2^(bits+1) + 2) << shift, so after >> shift every accumulator value
    0 .. 2^(bits+1) + 1 appears: the requantize edges 2^b - 1, 2^b and
    2^b + 1 among them."""
    span = ((2 << bits) + 2) << shift
    qa = (np.arange(span)[None, :] < np.arange(span)[:, None]).astype(np.int32)
    qb = np.random.default_rng(bits).integers(0, 1 << bits, (span, 24)).astype(np.int32)
    qb[:, 0] = 1
    return qa, qb


def blocky_levels(seed, m, k, bits, density=0.02):
    """Levels A (m x k) at ``bits`` whose occupied 256 x 256 tiles are
    every third one ((i + j) % 3 == 0, shifted per row tile), sparse
    inside: the zero tiles a TileMap skips."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 1 << bits, (m, k)) * (rng.random((m, k)) < density)
    for i in range(-(-m // 256)):
        for j in range(-(-k // 256)):
            if (i + j) % 3:
                q[i * 256:(i + 1) * 256, j * 256:(j + 1) * 256] = 0
    return q.astype(np.int32)


def hand_map(tm):
    """A copy of the TileMap ``tm`` that the kernels must follow as
    plain does: row tile 0 lists its first tile twice and leaves later
    ones out, row 1 has kcnt 0, row 2 lists entries outside the grid (-1
    and nk), row 3 has kcnt past nk over every tile in reverse, and the
    last row kcnt -1."""
    kidx, kcnt = tm.kidx.clone(), tm.kcnt.clone()
    nm, nk = kidx.shape
    kcnt[0] = min(2, nk)
    kidx[0, :2] = kidx[0, 0]
    if nm > 1:
        kcnt[1] = 0
    if nm > 2:
        kidx[2, 0], kidx[2, 1 % nk] = -1, nk
        kcnt[2] = min(3, nk)
    if nm > 3:
        kcnt[3] = nk + 5
        kidx[3] = kidx.new_tensor(list(range(nk - 1, -1, -1)))
    kcnt[-1] = -1
    return type(tm)(kidx, kcnt, tm.tile_m, tm.tile_k)


def mega_case(seed, B, pn, bits, hidden, keep=None, chunk=512, cb=256,
              feat=128, ncls=40, shift=0):
    """Operands of the whole-model kernel: levels qa [B, pn, pn] (0/1),
    qx [B, pn, feat] and three weights [feat, hidden], [hidden, hidden],
    [hidden, ncls], at densities that keep every GEMM of the chain off
    its requantize clamp. ``keep[b][c]`` lists the column blocks (width
    ``cb``) of row chunk ``c`` (height ``chunk``) that hold edges in
    batch ``b``; the others are all zero, so the occupancy schedule is
    exactly ``keep``. Returns (qa, qx, qws, a_words, x_digits)."""
    from qgtc_ppopp22_tpu_torch.ops.packmm import pack_rows_np

    rng = np.random.default_rng(seed)
    qa = (rng.random((B, pn, pn)) < linear_density(pn, 1, bits, bits, shift)).astype(np.int32)
    if keep is not None:
        for b, chunks in enumerate(keep):
            for c, js in enumerate(chunks):
                rows = qa[b, c * chunk:(c + 1) * chunk]
                for j in range(pn // cb):
                    if j in js:
                        rows[0, j * cb] = 1  # the block is occupied for sure
                    else:
                        rows[:, j * cb:(j + 1) * cb] = 0
    qx = rng.integers(0, 1 << bits, (B, pn, feat)).astype(np.int32)
    dims = [feat, hidden, hidden, ncls]
    qws = []
    for k, n in zip(dims, dims[1:]):
        # about 2 << shift nonzeros per column, mostly level 1 (so H x W
        # stays near 2^bits), one in ten of any level (both digit planes)
        nz = rng.random((k, n)) < min(1.0, (2 << shift) / k)
        big = rng.random((k, n)) < 0.1
        w = nz * np.where(big, rng.integers(1, 1 << bits, (k, n)), 1)
        qws.append(w.astype(np.int32))
    a_words = np.stack([pack_rows_np(q, 1)[0] for q in qa])
    xp = -(-feat // 128) * 128
    xl = np.zeros((B, pn, xp), np.int32)
    xl[:, :, :feat] = qx
    nd = -(-bits // 4)
    x_digits = np.stack([(xl >> (4 * d)) & ((1 << min(4, bits - 4 * d)) - 1) for d in range(nd)], axis=1)
    return qa, qx, qws, a_words, x_digits.astype(np.int8)


def levels_plane(x_digits):
    """Digit planes int8[B, nd, pn, xp] -> levels-form X int8[B, 1, pn, xp]:
    each byte the whole level (the mega engine's staging of 5-8-bit X)."""
    lv = sum(x_digits[:, d].astype(np.int32) << (4 * d) for d in range(x_digits.shape[1]))
    return lv.astype(np.uint8).view(np.int8)[:, None]


def requant_np(acc, bits, shift=0):
    """The reference requantizer on int64 sums: after >> shift, above 2^b
    clamps to 2^b - 1, below 0 to 1, then the low b bits (2^b wraps to 0)."""
    v = acc >> shift
    ub = 1 << bits
    return np.where(v > ub, ub - 1, np.where(v < 0, 1, v)) & (ub - 1)


def chain_shifts(qa, qx, qws, model, bits, rows=None):
    """A NumPy integer chain (``qgcn_forward`` / ``qgin_forward`` order)
    whose every requantize shift is the smallest that leaves more than half
    of its stage's levels (over the first ``rows`` rows, the real nodes;
    default all) below the 2^bits - 1 rail, so a clobbered level changes
    the logits instead of landing on the rail. Returns (shifts, each
    stage's share of levels below the rail, int64 logits)."""
    qa, h = qa.astype(np.int64), qx.astype(np.int64)
    ws = [w.astype(np.int64) for w in qws]
    rail = (1 << bits) - 1

    def below(r):
        return float((r[:rows] < rail).mean())

    shifts, shares = [], []

    def stage(acc):
        s = next(s for s in range(32) if below(requant_np(acc, bits, s)) > 0.5)
        r = requant_np(acc, bits, s)
        shifts.append(s)
        shares.append(below(r))
        return r

    if model == "gcn":
        for l, w in enumerate(ws):
            h = stage(h @ w)
            if l < len(ws) - 1:
                h = stage(qa @ h)
        return shifts, shares, qa @ h
    h = stage(qa @ h)
    for w in ws[:-1]:
        h = stage(qa @ stage(h @ w))
    return shifts, shares, h @ ws[-1]


# Tolerance of the bf16 baseline chain, per row of logits: max |port - ref|
# over the row <= 2^-6 * the row's scale, the larger of its own max |ref|
# and the median row's max |ref| in its batch (rows whose ref is all 0 left
# out of the median; where the scale is 0 both sides must be 0). A float32
# sum taken in another order can move a bf16 rounding by one ulp (at most
# 2^-7 of the value rounded) at any of the chain's 2n casts. The value
# rounded has the size of an ordinary row's, not of this row's logits,
# which can cancel to a tenth of it: hence the median. Not the batch's
# largest row: its dense (hub) rows reach logits thousands of times an
# ordinary row's and would hide any ordinary row's error. The readings lie
# between 1e-7 and 2e-3 (JAX against the port on the CPU, the kernel
# against plain on the card); 2^-6 = 1.6e-2 leaves room above them. No
# limit of this kind tells one rounding mode from another: the "integer"
# and "rounding" cases of ``baseline_case`` must be equal bit for bit.
BF16_REL_TOL = 2.0 ** -6


def bf16_rel_err(got, ref) -> float:
    """The worst row's max |got - ref| over its scale (above). Rows lie
    along the last axis, a batch's rows along the one before it."""
    got, ref = (np.asarray(t.detach().cpu() if hasattr(t, "detach") else t, np.float64)
                for t in (got, ref))
    diff = np.abs(got - ref).max(axis=-1)
    rowmax = np.abs(ref).max(axis=-1)
    typical = np.zeros(rowmax.shape[:-1] + (1,))
    for i in np.ndindex(rowmax.shape[:-1]):
        nz = rowmax[i][rowmax[i] > 0]
        typical[i] = np.median(nz) if nz.size else 0.0
    scale = np.maximum(rowmax, typical)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.where(diff > 0, diff / scale, 0.0).max())


def baseline_case(seed, B, pn, dims, kind="random"):
    """Operands of the bf16 baseline chain: A int8 [B, pn, pn] of 0/1, X
    float32 [B, pn, dims[0]], weights float32 [dims[i], dims[i+1]].

    ``kind``:
    - ``"random"``: A at about 6 edges per row (an ogbn-arxiv cluster
      batch) plus 4 rows half full, X normal, W normal * 0.1 (the
      engine's initialisation);
    - ``"integer"``: every intermediate is an integer exact in bf16: A
      has at most 2 ones per row, X is 0/1 and W is -1/0/1 with at most 2
      nonzeros per column, so magnitudes grow at most 4x per layer (64
      after 3 layers). No rounding happens anywhere;
    - ``"rounding"``: A and W as in ``"integer"``, X float32 of magnitude
      in [1, 2) and either sign. In bf16 X is a multiple of 2^-7, and so
      is every later value, which stays below 2^8: every float32 sum is
      exact in any order and in any adder (a tensor core's truncating
      alignment included), while X, the aggregations and the relu
      outputs need more than bf16's 8 significant bits: each of the
      chain's casts rounds, and only the same rounding mode (to nearest
      even) gives the same bits."""
    if kind not in ("random", "integer", "rounding"):
        raise ValueError(f"unknown case kind {kind!r}")
    rng = np.random.default_rng(seed)
    a = np.zeros((B, pn, pn), np.int8)
    sparse = kind != "random"
    if sparse:
        for b in range(B):
            for r in range(pn):
                a[b, r, rng.choice(pn, rng.integers(0, 3), replace=False)] = 1
    else:
        a[:] = rng.random((B, pn, pn)) < 6.0 / pn
        a[:, rng.choice(pn, 4, replace=False)] = rng.random((B, 4, pn)) < 0.5
    if kind == "integer":
        x = rng.integers(0, 2, (B, pn, dims[0])).astype(np.float32)
    elif kind == "rounding":
        x = (rng.uniform(1, 2, (B, pn, dims[0])) * rng.choice([-1, 1], (B, pn, dims[0])))
        x = x.astype(np.float32)
    else:
        x = rng.standard_normal((B, pn, dims[0])).astype(np.float32)
    ws = []
    for k, n in zip(dims, dims[1:]):
        if sparse:
            w = np.zeros((k, n), np.float32)
            for c in range(n):
                rows = rng.choice(k, rng.integers(1, 3), replace=False)
                w[rows, c] = rng.choice([-1.0, 1.0], len(rows))
        else:
            w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
        ws.append(w)
    return a, x, ws


# K2's 1/2/4-bit kernel (csrc/packmm_k2.cuh): the cases the CUDA tests and
# chip_smoke.py hold against plain. Output forms as packmm._packmm's
# (out_bits, out_form, shift, raw_i32, out_cols); "n" stores N columns.
K2_WIDTHS = (8, 16, 24, 40, 64, 72, 200)
K2_FORMS = ((2, "digits", 1, False, None), (None, "f32", 0, False, "n"), (None, "f32", 0, True, None),
            (1, "packed", 0, False, "n"), (2, "packed", 0, False, None), (4, "packed", 0, False, "n"),
            (8, "packed", 0, False, "n"))
K2_KP = 448  # 64 * 7: an odd number of 64-deep steps


def k2_operands(seed, m, k, n, a_bits, b_bits, device, kp=None, blocky=False):
    """A at ``a_bits`` (M-packed) and B at ``b_bits`` (digit planes) on
    ``device``; with ``kp`` (a multiple of 64 below the 128-padded depth)
    both cut to that padded depth, whose dropped columns hold level 0."""
    import torch

    from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor, digit_pack
    from qgtc_ppopp22_tpu_torch.ops.packmm import PackedTensor, pack_rows

    rng = np.random.default_rng(seed)
    qa = blocky_levels(seed, m, k, a_bits, 0.3) if blocky else rng.integers(0, 1 << a_bits, (m, k))
    qb = rng.integers(0, 1 << b_bits, (k, n))
    a = pack_rows(torch.from_numpy(qa.astype(np.int32)), a_bits)
    b = digit_pack(torch.from_numpy(qb.astype(np.int32)), b_bits)
    if kp is not None:
        a = PackedTensor(words=a.words[:, :, :kp].contiguous(), shape=a.shape, bits=a.bits)
        b = DigitTensor(digits=b.digits[:, :kp].contiguous(), shape=b.shape, bits=b.bits)
    return a.to(device), b.to(device)


def k2_calls(a, b, tile_map=None, splits=None, forms=K2_FORMS):
    """(tag, kernel, plain) for each output form of ``a`` x ``b``: the
    kernel through ``packmm._packmm`` on :func:`packmm.packmm_plan`'s plan,
    its split replaced by ``splits`` where given (forms whose plan cannot
    take that split are left out), and ``packmm_plain``."""
    import dataclasses

    from qgtc_ppopp22_tpu_torch.ops import packmm

    n = b.shape[1]
    calls = []
    for out_bits, form, shift, raw, oc in forms:
        out_cols = n if oc == "n" else oc
        ocp = packmm._stored_cols(form, out_cols, b.padded_cols)
        plan = packmm.packmm_plan(a.padded_rows, a.padded_cols, b.padded_cols, n,
                                  packmm._plan_form(out_bits, form, raw), ocp, tile_map)
        if splits is not None:
            if plan.cluster[1] > 1 and splits > packmm.PACK_SPLIT:
                continue
            plan = dataclasses.replace(plan, splits=splits, cluster=(*plan.cluster[:2], splits),
                                       grid=(*plan.grid[:2], splits))
        tag = f"out_bits={out_bits} {form} shift={shift} i32={raw} out_cols={out_cols} {plan}"
        calls.append((tag,
                      lambda ob=out_bits, f=form, s=shift, r=raw, c=out_cols, p=plan:
                      packmm._packmm(a, b, ob, f, s, r, c, tile_map, _plan=p),
                      lambda ob=out_bits, f=form, s=shift, r=raw, c=out_cols:
                      packmm.packmm_plain(a, b, ob, s, r, f, c, tile_map)))
    return calls


def k2_groups():
    """Every group of K2 cases: (id, kwargs of :func:`k2_group`). Widths N
    at 1/2/4 bits against one and two digit planes of B (one 256-row
    group, depth 448); every split at N 24 (the plan takes 3 there); maps
    with kcnt 0, kcnt below the split, entries outside the grid, kcnt past
    the grid and -1 (``hand_map``) at every split; packed words stored at
    out_cols 8, 40, 64 and 200."""
    out = []
    for n in K2_WIDTHS:
        for a_bits in (1, 2, 4):
            for b_bits in (2, 8):
                out.append((f"widths-n{n}-a{a_bits}-b{b_bits}",
                            dict(seed=n + 7 * a_bits + b_bits, m=256, k=K2_KP, n=n, a_bits=a_bits,
                                 b_bits=b_bits, kp=K2_KP)))
    for a_bits in (1, 2, 4):
        for s in (1, 2, 3, 4):
            out.append((f"split{s}-a{a_bits}", dict(seed=40 + a_bits, m=768, k=K2_KP, n=24, a_bits=a_bits,
                                                   b_bits=2, kp=K2_KP, splits=s)))
            out.append((f"map-split{s}-a{a_bits}", dict(seed=50 + a_bits, m=1280, k=512, n=40, a_bits=a_bits,
                                                       b_bits=2, splits=s, hand=True)))
    for oc in (8, 40, 64, 200):
        for a_bits in (1, 2, 4):
            out.append((f"words-oc{oc}-a{a_bits}", dict(seed=60 + oc + a_bits, m=512, k=K2_KP, n=200,
                                                       a_bits=a_bits, b_bits=4, kp=K2_KP, out_cols=oc)))
    return out


def k2_group(device, seed, m, k, n, a_bits, b_bits, kp=None, splits=None, hand=False, out_cols=None):
    """The (tag, kernel, plain) calls of one :func:`k2_groups` entry."""
    from qgtc_ppopp22_tpu_torch.ops import packmm

    a, b = k2_operands(seed, m, k, n, a_bits, b_bits, device, kp, blocky=hand)
    tile_map = hand_map(packmm.build_tile_map_packed(a, 256, 128)) if hand else None
    forms = K2_FORMS
    if out_cols is not None:
        forms = tuple((ob, "packed", 0, False, out_cols) for ob in (1, 2, 4))
    return k2_calls(a, b, tile_map, splits, forms)


def k2_chain(device, a_bits, seed=70):
    """Packed words out fed back as the next product's A, twice, at each
    output width: (tag, kernel, plain) of the last product, each side
    chaining its own outputs."""
    from qgtc_ppopp22_tpu_torch.ops import packmm
    from qgtc_ppopp22_tpu_torch.ops.packmm import PackedTensor

    a, b1 = k2_operands(seed, 512, 300, 256, a_bits, 2, device)
    _, b2 = k2_operands(seed + 1, 256, 256, 128, 1, 2, device)
    _, b3 = k2_operands(seed + 2, 128, 128, 40, 1, 4, device)

    def chain(mm):
        x = mm(a, b1, a_bits)
        x = mm(PackedTensor(words=x.words, shape=(512, 256), bits=a_bits), b2, a_bits)
        return mm(PackedTensor(words=x.words, shape=(512, 128), bits=a_bits), b3, a_bits)

    return (f"chain {a_bits}-bit words x3",
            lambda: chain(lambda x, y, ob: packmm.packmm_to_packed(x, y, ob)),
            lambda: chain(lambda x, y, ob: packmm.packmm_plain(x, y, ob, out_form="packed")))


# K4's kernel (csrc/packmm_k4.cuh) for a 5-8-bit A (the offset-signed byte
# plane): the PreparedRHS product and K2's 8-bit plane against digit
# planes, the cases the CUDA tests and chip_smoke.py hold against plain
# under every forced plan. Forms as K2_FORMS; "n" stores N columns.
K4_FORMS = ((None, "f32", 0, False, None), (None, "f32", 0, False, "n"), (None, "f32", 0, True, None),
            (2, "digits", 1, False, None), (8, "digits", 0, False, None), (8, "packed", 0, False, None),
            (5, "packed", 2, False, "n"), (1, "packed", 0, False, "n"), (2, "packed", 0, False, "n"),
            (4, "packed", 1, False, "n"))
K4_KP = K2_KP  # 7 steps of 64: odd remainders over every split


def k4_levels(seed, m, k, n, a_bits, b_bits, data="random", blocky=False):
    """Levels A (m x k) at ``a_bits`` and B (k x n) at ``b_bits``: random
    (half the requantizer's range on each side of its clamp at 8 bits
    out), ``blocky`` (``blocky_levels``' zero tiles), or the extremes of
    ``test_packmm_signed_extremes``: "zero_a" (A at level 0, B at the
    top) and "top" (both at the top level)."""
    rng = np.random.default_rng(seed)
    top_a, top_b = (1 << a_bits) - 1, (1 << b_bits) - 1
    if data == "zero_a":
        return np.zeros((m, k), np.int32), np.full((k, n), top_b, np.int32)
    if data == "top":
        return np.full((m, k), top_a, np.int32), np.full((k, n), top_b, np.int32)
    qa = blocky_levels(seed, m, k, a_bits, 0.3) if blocky else rng.integers(0, top_a + 1, (m, k))
    return qa.astype(np.int32), rng.integers(0, top_b + 1, (k, n)).astype(np.int32)


def k4_operands(seed, m, k, n, a_bits, b_bits, device, kp=None, prepared=True, data="random", blocky=False):
    """A at ``a_bits`` (the signed plane) and B at ``b_bits``: its
    ``PreparedRHS`` (``prepared``) or its digit planes, on ``device``;
    with ``kp`` (a multiple of 64 below the 128-padded depth) both cut to
    that padded depth (the PreparedRHS prepared after the cut, so that its
    correction counts ``kp``)."""
    import torch

    from qgtc_ppopp22_tpu_torch.ops.digits import DigitTensor, digit_pack
    from qgtc_ppopp22_tpu_torch.ops.packmm import PackedTensor, pack_rows, prepare_rhs

    qa, qb = k4_levels(seed, m, k, n, a_bits, b_bits, data, blocky)
    a = pack_rows(torch.from_numpy(qa), a_bits)
    b = digit_pack(torch.from_numpy(qb), b_bits)
    if kp is not None:
        a = PackedTensor(words=a.words[:, :, :kp].contiguous(), shape=a.shape, bits=a.bits)
        b = DigitTensor(digits=b.digits[:, :kp].contiguous(), shape=b.shape, bits=b.bits)
    a, b = a.to(device), b.to(device)
    return a, prepare_rhs(b) if prepared else b


def k4_plans(a, b, form, ocp, n, tile_map=None):
    """Every launch the tests force for one output form: each column tile
    (16, 32, 64) with each split (1-4; 1-2 for packed words), on
    ``packmm_signed_plan``'s grid for ``n`` (the columns not stored as
    level 0)."""
    import dataclasses

    from qgtc_ppopp22_tpu_torch.ops import packmm

    np_ = b.plane.shape[1] if isinstance(b, packmm.PreparedRHS) else b.padded_cols
    plans = []
    for bnt in (16, 32, 64):
        p = packmm.packmm_signed_plan(a.padded_rows, a.padded_cols, np_, n, form, ocp, tile_map, bnt=bnt)
        for s in range(1, (packmm.PACK_SPLIT if form == "words" else packmm.MAX_SPLIT) + 1):
            plans.append(dataclasses.replace(p, splits=s, cluster=(*p.cluster[:2], s), grid=(*p.grid[:2], s)))
    return plans


def k4_groups():
    """Every group of K4 cases: (id, kwargs of :func:`k4_group`). The
    PreparedRHS product at N 16, 60, 64 and 120 (120: the last free lane)
    with 8-bit A, at N 60 with 5-bit A, at depth 448 (7 K steps: odd
    remainders over every split) and at 1024²; the stored columns at
    out_cols 8, 40, 64 and 200 (N 200, 256 padded lanes, the masked lanes
    stored); the extremes (A at level 0, everything at 255, and K 32640,
    the deepest the int32 guard takes). K2's 8-bit plane at N 16, 60 and
    120 against one and two digit planes of B, 5- and 8-bit A; maps with
    kcnt 0, below the split, past the grid and -1 and entries outside it
    (``hand_map``); packed words at out_cols 8, 64 and 200."""
    out = []
    for n in (16, 60, 64, 120):
        out.append((f"prepared-n{n}-a8", dict(seed=100 + n, m=700, k=K4_KP, n=n, a_bits=8, b_bits=8, kp=K4_KP)))
    out.append(("prepared-n60-a5", dict(seed=170, m=700, k=K4_KP, n=60, a_bits=5, b_bits=6, kp=K4_KP)))
    out.append(("prepared-1024-n64", dict(seed=171, m=1024, k=1024, n=64, a_bits=8, b_bits=8)))
    for oc in (8, 40, 64, 200):
        out.append((f"prepared-oc{oc}", dict(seed=180 + oc, m=512, k=K4_KP, n=200, a_bits=8, b_bits=8, kp=K4_KP,
                                             out_cols=oc)))
    out.append(("prepared-a0", dict(seed=0, m=700, k=300, n=60, a_bits=8, b_bits=8, data="zero_a")))
    out.append(("prepared-top", dict(seed=0, m=700, k=300, n=60, a_bits=8, b_bits=8, data="top")))
    out.append(("prepared-k32640", dict(seed=0, m=256, k=32640, n=16, a_bits=8, b_bits=8, data="top")))
    for n in (16, 60):
        for b_bits in (4, 8):
            out.append((f"planes-n{n}-b{b_bits}", dict(seed=200 + n + b_bits, m=700, k=K4_KP, n=n, a_bits=8,
                                                       b_bits=b_bits, kp=K4_KP, prepared=False)))
    out.append(("planes-n120-a5", dict(seed=230, m=700, k=K4_KP, n=120, a_bits=5, b_bits=8, kp=K4_KP,
                                       prepared=False)))
    for b_bits in (4, 8):
        out.append((f"planes-map-b{b_bits}", dict(seed=240 + b_bits, m=1280, k=512, n=40, a_bits=8, b_bits=b_bits,
                                                  prepared=False, hand=True)))
    for oc in (8, 64, 200):
        out.append((f"planes-oc{oc}", dict(seed=250 + oc, m=512, k=K4_KP, n=200, a_bits=8, b_bits=4, kp=K4_KP,
                                           prepared=False, out_cols=oc)))
    return out


def k4_group(device, seed, m, k, n, a_bits, b_bits, kp=None, prepared=True, data="random", hand=False,
             out_cols=None):
    """The (tag, kernel, plain) calls of one :func:`k4_groups` entry: each
    form (:data:`K4_FORMS` for a PreparedRHS, :data:`K2_FORMS` against
    digit planes; words and the signed plane at ``out_cols`` where it is
    given, with f32 there for the PreparedRHS) under every plan of
    :func:`k4_plans`, through ``packmm._packmm(..., _plan=)``; plain
    computed once per form."""
    import functools

    from qgtc_ppopp22_tpu_torch.ops import packmm

    a, b = k4_operands(seed, m, k, n, a_bits, b_bits, device, kp, prepared, data, blocky=hand)
    tile_map = hand_map(packmm.build_tile_map_packed(a, 256, 128)) if hand else None
    forms = K4_FORMS if prepared else K2_FORMS
    if out_cols is not None:
        forms = tuple((ob, "packed", 0, False, out_cols) for ob in (1, 2, 4, 8))
        forms += ((None, "f32", 0, False, out_cols),) if prepared else ()
    calls = []
    for out_bits, form, shift, raw, oc in forms:
        c = n if oc == "n" else oc
        pform = packmm._plan_form(out_bits, form, raw)
        if prepared:
            ocp, cols = packmm._signed_stores(a, b, out_bits, form, c)
        else:
            ocp, cols = packmm._stored_cols(form, c, b.padded_cols), n
        plain = functools.cache(lambda ob=out_bits, f=form, s=shift, r=raw, c=c:
                                packmm.packmm_plain(a, b, ob, s, r, f, c, tile_map))
        for p in k4_plans(a, b, pform, ocp, cols, tile_map):
            tag = (f"K4 {'PreparedRHS' if prepared else f'{b.ndigits} B plane(s)'} {a_bits}-bit A M={m} K={k} "
                   f"N={n} {data} map={hand} out_bits={out_bits} {form} shift={shift} i32={raw} out_cols={c} {p}")
            calls.append((tag, lambda ob=out_bits, f=form, s=shift, r=raw, c=c, p=p:
                          packmm._packmm(a, b, ob, f, s, r, c, tile_map, _plan=p), plain))
    return calls


# K6's kernel (csrc/bitmm_k6.cuh): the cases the CUDA tests and
# chip_smoke.py hold against plain under every forced plan.

def k6_groups():
    """Every group of K6 cases: (id, kwargs of :func:`k6_group`). C1's six
    GEMMs (the layer-0 update X[2560x128] x W[128x16]; the aggregation
    A[2560²] x H[2560x16] to bits, twice a batch; the hidden updates
    H[2560x16] x W[16x16] and x W[16x40]; the aggregation x H[2560x40] to
    f32), the aggregation at N 40 and 64 and GIN's hidden update (64 x 64),
    the ragged 300 x 520 x 40 (three K steps, fewer than S = 4), every plane
    pair the kernel instantiates (1 x 1, 2, 4, 8; 2 x 2, 4 x 4, 8 x 8) and a
    run-time one (3 x 5), maps (the builder's and ``hand_map``'s: occupied
    tiles left out, kcnt 0, -1 and past the grid, entries outside it) on
    C1's aggregation and a ragged 2300 x 520 x 40 (nine 256-row map rows),
    and 8 x 8 planes at 255 with K
    33280, whose sums pass 2^31 and wrap."""
    c1 = [("c1-update0", 2560, 128, 16, 2, 2), ("c1-agg", 2560, 2560, 16, 1, 2),
          ("c1-update1", 2560, 16, 16, 2, 2), ("c1-update2", 2560, 16, 40, 2, 2),
          ("c1-agg40", 2560, 2560, 40, 1, 2), ("agg-n64", 2560, 2560, 64, 1, 2),
          ("gin-update", 2560, 64, 64, 2, 2)]
    out = [(gid, dict(seed=80 + i, m=m, k=k, n=n, a_bits=ab, b_bits=bb))
           for i, (gid, m, k, n, ab, bb) in enumerate(c1)]
    for ab, bb in ((1, 1), (1, 2), (1, 4), (1, 8), (2, 2), (4, 4), (8, 8), (3, 5)):
        out.append((f"ragged-a{ab}-b{bb}", dict(seed=90 + 9 * ab + bb, m=300, k=520, n=40, a_bits=ab,
                                                b_bits=bb)))
    for kind in ("real", "hand"):
        out.append((f"c1-agg-map-{kind}", dict(seed=120, m=2560, k=2560, n=16, a_bits=1, b_bits=2, tile_map=kind)))
        out.append((f"ragged-map-{kind}", dict(seed=121, m=2300, k=520, n=40, a_bits=3, b_bits=2, tile_map=kind)))
    out.append(("wrap-8x8-k33280", dict(seed=130, m=256, k=33280, n=16, a_bits=8, b_bits=8, full=True)))
    return out


def k6_group(device, seed, m, k, n, a_bits, b_bits, tile_map=None, full=False):
    """The (tag, kernel, plain) calls of one :func:`k6_groups` entry: to
    ``b_bits`` planes and to f32, each on every column tile and every
    split 1-4 forced through ``bitgemm._bitmm(..., _plan=)``; plain is
    computed once per output form."""
    import dataclasses
    import functools

    import torch

    from qgtc_ppopp22_tpu_torch.ops import bitgemm
    from qgtc_ppopp22_tpu_torch.ops.bitpack import pack_bits

    if full:
        qa, qb = np.full((m, k), (1 << a_bits) - 1, np.int32), np.full((k, n), (1 << b_bits) - 1, np.int32)
    elif tile_map is not None:
        qa, qb = blocky_levels(seed, m, k, a_bits, 0.05), operands(seed, m, k, n, a_bits, b_bits, 2, 0)[1]
    else:
        qa, qb = operands(seed, m, k, n, a_bits, b_bits, min(b_bits, 4), 0)
    a, b = (pack_bits(torch.from_numpy(q).to(device), bits) for q, bits in ((qa, a_bits), (qb, b_bits)))
    tm = None
    if tile_map is not None:
        tm = bitgemm.build_tile_map(a)
        tm = hand_map(tm) if tile_map == "hand" else tm
    calls = []
    for out_bits in (b_bits, None):
        plain = functools.cache(lambda ob=out_bits: bitgemm.bitmm_plain(a, b, ob, tm))
        for bnt in (16, 32, 64):
            chosen = bitgemm.bitmm_plan(a.padded_rows, a.padded_cols, b.padded_cols, n,
                                        "f32" if out_bits is None else "bits", tm, bnt=bnt)
            for s in range(1, bitgemm.MAX_SPLIT + 1):
                plan = dataclasses.replace(chosen, splits=s, cluster=(1, 1, s), grid=(*chosen.grid[:2], s))
                tag = f"{a_bits}x{b_bits} M={m} K={k} N={n} out_bits={out_bits} map={tile_map} {plan}"
                calls.append((tag, lambda ob=out_bits, p=plan: bitgemm._bitmm(a, b, ob, tm, _plan=p), plain))
    return calls


# K1's whole-model kernel (csrc/fused_model_k1.cuh): the cases the CUDA
# tests and chip_smoke.py hold against plain under every forced plan.
# Forms of X: (bits, levels form, hidden width or None for the model's,
# every byte's bits above ``bits`` set: the split form must mask them off)
K1_FORMS = {"digits2": (2, False, None, False), "digits8": (8, False, None, False),
            "signed8": (8, True, None, False), "split8": (8, True, 128, False),
            "signed1": (1, True, None, False), "signed2": (2, True, None, False),
            "split1": (1, True, 128, False), "split2": (2, True, 128, False), "split4": (4, True, 128, False),
            "split3-noisy": (3, True, 128, True)}
# shapes: (B, pn) and each batch's occupied column blocks per row chunk
# (``mega_case``'s keep): chunks with all, none, one, odd and even counts
K1_SHAPES = {
    "c1": (2, 2560, [[[0, 1, 2, 3, 4], [], [2], [0, 2, 4], [1, 3]],
                     [[0, 1, 2], [4], [0, 1, 2, 3, 4], [], [0, 3]]]),
    "pn768": (3, 768, [[[0, 1, 2], [1], []], [[2], [0, 2], [0, 1, 2]], [[], [0], [1, 2]]]),
}


def k1_groups():
    """Every group of K1 cases: (id, kwargs of :func:`k1_group`). C1's
    shape (pn 2560, 2 batches) and odd remainders (pn 768, 3 batches of 12
    row tiles); GCN at hidden 16 and GIN at hidden 64; every form of X
    (digit planes at 2 and 8 bits, the signed chain at 8, 1 and 2 bits and
    the split form at 8, 1, 2 and 4 bits: the 1-4-bit levels form, each with
    its own masks; the split forms at hidden 128, where no weight has a free
    lane; 3-bit levels whose bytes carry set bits above the level);
    feature widths 100 and 128 in turns."""
    out = []
    for s, sname in enumerate(K1_SHAPES):
        for model, hidden in (("gcn", 16), ("gin", 64)):
            for i, form in enumerate(K1_FORMS):
                feat = 100 if (i + s) % 2 else 128
                out.append((f"{sname}-{model}-{form}-f{feat}",
                            dict(shape=sname, model=model, hidden=hidden, form=form, feat=feat,
                                 seed=200 + 17 * s + 5 * i + (model == "gin"))))
    return out


def k1_plans(p, model):
    """Every launch the tests force for the geometry ``p``: the chosen
    plan, 64- and 128-row CTAs, the chosen rows at each stage depth (64,
    128, 256 columns) on a ring of 3 stages, and on a cluster of 2 CTAs
    (more row tiles each); the plans the kernel cannot run (too much shared
    memory) are left out."""
    from qgtc_ppopp22_tpu_torch.ops import fused_model

    chosen = fused_model.fused_model_plan(p, model)
    tries = [{}] + [dict(rows=r) for r in fused_model.K1_ROWS]
    tries += [dict(rows=chosen.rows, depth=d, stages=3) for d in fused_model.K1_DEPTHS]
    tries += [dict(rows=chosen.rows, cl=2)]
    plans = []
    for kw in tries:
        try:
            kp = fused_model.fused_model_plan(p, model, **kw)
        except ValueError:
            continue
        if kp not in plans:
            plans.append(kp)
    return plans


def k1_group(device, shape, model, hidden, form, feat, seed):
    """The (tag, kernel, plain) calls of one :func:`k1_groups` entry: dense,
    a block schedule that leaves out occupied blocks, and the 2-D
    occupancy map as ``chunk_occ``, each under every plan of
    :func:`k1_plans` through ``fused_model_epoch(..., _plan=)``; plain is
    computed once per zero-block form. Shifts from :func:`chain_shifts` on
    batch 0 keep every stage off its requantize rail."""
    import functools

    import torch

    from qgtc_ppopp22_tpu_torch.ops import fused_model
    from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack
    from qgtc_ppopp22_tpu_torch.runtime import mega_block_occ, mega_block_sched

    bits, levels, wide, noisy = K1_FORMS[form]
    hidden = wide or hidden
    B, pn, keep = K1_SHAPES[shape]
    chunk = 512 if pn % 512 == 0 else 256
    cb = fused_model.mega_colblock(pn)
    qa, qx, qws, aw, xd = mega_case(seed, B, pn, bits, hidden, keep=keep, chunk=chunk, cb=cb, feat=feat)
    shifts = chain_shifts(qa[0], qx[0], qws, model, bits)[0]
    xn = levels_plane(xd) if levels else xd
    if noisy:  # every bit above the level set
        xn = (xn.view(np.uint8) | np.uint8(0xFF ^ ((1 << bits) - 1))).view(np.int8)
    x = torch.from_numpy(xn).to(device)
    a = torch.from_numpy(aw).to(device)
    ws = [digit_pack(torch.from_numpy(w).to(device), bits) for w in qws]
    sched = np.stack([mega_block_sched(w[None], chunk, cb) for w in aw])
    full = int(np.argmax(sched[0, :, 0]))  # batch 0's fullest chunk
    sched[0, full, 0] -= 2  # its last two listed (occupied) blocks left out
    occ = np.stack([mega_block_occ(w[None], chunk, cb) for w in aw])
    kw = dict(model=model, shifts=shifts, out_cols=40, x_cols=feat, x_levels_bits=bits if levels else None)
    p = fused_model.plan(a.shape, x.shape, ws, bits, model, shifts, 40, x_levels_bits=kw["x_levels_bits"])
    calls = []
    for zname, zkw in (("dense", {}), ("blk_sched", dict(blk_sched=torch.from_numpy(sched).to(device))),
                       ("chunk_occ", dict(chunk_occ=torch.from_numpy(occ).to(device)))):
        plain = functools.cache(lambda z=zkw: fused_model.fused_model_epoch_plain(a, x, ws, bits, **kw, **z))
        for kp in k1_plans(p, model):
            tag = (f"K1 {model} {form} B={B} pn={pn} hidden={hidden} feat={feat} {zname} ({p.form}) "
                   f"rows {kp.rows} cl {kp.cl} stages {kp.stages} depth {kp.depth}")
            calls.append((tag, lambda z=zkw, pl=kp: fused_model.fused_model_epoch(a, x, ws, bits, **kw, **z,
                                                                                  _plan=pl), plain))
    return calls


# K5's baseline kernel (csrc/fused_baseline_k5.cuh): the cases the CUDA
# tests and chip_smoke.py hold against plain under every forced plan.
# Case kinds (``baseline_case``): "integer" and "rounding" bit for bit,
# "random" within BF16_REL_TOL; at 8 layers the "rounding" case's values
# can pass 2^17, where an f32 sum of multiples of 2^-7 need not be exact,
# so those groups hold "integer" and "random".

def k5_groups():
    """Every group of K5 cases: (id, kwargs of :func:`k5_group`). pn 512
    and 2560 (C1's), sage at hidden 16 and gin at hidden 64, 1, 3 and 8
    layers, odd batch counts (3, 5), pn 768 (6 row tiles of 128) and X
    200 wide at ragged widths (two aggregation passes of 128 and 80
    columns)."""
    rows = [("p512-sage-3l", "sage", 3, 512, [128, 16, 16, 40]),
            ("p512-gin-3l", "gin", 2, 512, [128, 64, 64, 40]),
            ("p512-1l", "sage", 3, 512, [128, 40]),
            ("p512-sage-8l", "sage", 3, 512, [128] + [16] * 7 + [40]),
            ("p512-gin-8l", "gin", 2, 512, [128] + [64] * 7 + [40]),
            ("p768-gin-3l", "gin", 5, 768, [128, 64, 64, 40]),
            ("p512-x200-ragged", "sage", 3, 512, [200, 24, 10]),
            ("p2560-sage-3l", "sage", 3, 2560, [128, 16, 16, 40]),
            ("p2560-gin-3l", "gin", 2, 2560, [128, 64, 64, 40]),
            ("p2560-1l", "sage", 2, 2560, [128, 40])]
    return [(gid, dict(model=model, B=B, pn=pn, dims=dims, seed=300 + 7 * i))
            for i, (gid, model, B, pn, dims) in enumerate(rows)]


def k5_plans(B, pn, dims, sms=None):
    """Every launch the tests force at this shape on a card of ``sms`` SMs
    (None: the H100's 132): the chosen plan and one and two batches in
    flight; duplicates left out."""
    from qgtc_ppopp22_tpu_torch.ops import _gemm, fused_model

    a_shape, x_shape = (B, pn, pn), (B, pn, dims[0])
    ws = list(zip(dims, dims[1:]))
    sms = sms or _gemm.SMS
    tries = [{}] + [dict(g=g) for g in (1, 2) if g <= B]
    plans = []
    for kw in tries:
        p = fused_model.fused_baseline_plan(a_shape, x_shape, ws, sms=sms, **kw)
        if p not in plans:
            plans.append(p)
    return plans


def k5_group(device, model, B, pn, dims, seed):
    """The (tag, kind, kernel, plain) calls of one :func:`k5_groups` entry:
    each case kind under every plan of :func:`k5_plans` through
    ``fused_baseline_epoch(..., _plan=)`` on the card of ``device``; plain
    computed once per kind."""
    import functools

    import torch

    from qgtc_ppopp22_tpu_torch.ops import fused_model

    kinds = ("integer", "random") if len(dims) > 4 else ("integer", "rounding", "random")
    dev = torch.device(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else None
    calls = []
    for kind in kinds:
        a, x, ws = baseline_case(seed, B, pn, dims, kind=kind)
        a, x = torch.from_numpy(a).to(device), torch.from_numpy(x).to(device)
        ws = [torch.from_numpy(w).to(device) for w in ws]
        packed = fused_model.pack_baseline_weights(ws)
        plain = functools.cache(lambda a=a, x=x, ws=ws: fused_model.fused_baseline_epoch_plain(a, x, ws))
        for p in k5_plans(B, pn, dims, sms):
            tag = f"K5 {model} B={B} pn={pn} dims={dims} {kind} groups {p.groups} ctas {p.ctas} layers {p.kd}"
            calls.append((tag, kind, lambda a=a, x=x, ws=ws, pk=packed, p=p:
                          fused_model.fused_baseline_epoch(a, x, ws, packed=pk, _plan=p), plain))
    return calls


# K3's digit-plane kernel (csrc/digitmm_k3.cuh): the cases the CUDA tests
# and chip_smoke.py hold against plain, bit for bit over the whole padded
# output, under every forced plan.
K3_FORMS = (("digits", 1), ("f32", 0), ("i32", 0))  # (out form, shift)


def k3_groups():
    """Every group of K3 cases: (id, kwargs of :func:`k3_group`). C1's three
    updates (X[2560x128] x W[128x16], H[2560x16] x W[16x16] and x
    W[16x40]), N 16 / 40 / 64 / 128 / 200, K 16 / 128 / 256 / 700, 1 and 2
    digit planes on either side, and the K skip: a blocky 1-bit A[2560²]
    with ``build_tile_map_digits``'s map and ``hand_map``'s (tiles left out, kcnt 0, -1
    and past the grid, entries outside it), and a ragged 2300 x 520 one."""
    rows = [("c1-update0", 2560, 128, 16, 2, 2, None), ("c1-update1", 2560, 16, 16, 2, 2, None),
            ("c1-update2", 2560, 16, 40, 2, 2, None), ("gin-n64-8x8", 2560, 64, 64, 8, 8, None),
            ("n128-k256-4x8", 1000, 256, 128, 4, 8, None), ("k16-n128-8x4", 300, 16, 128, 8, 4, None),
            ("k256-n40-1x1", 512, 256, 40, 1, 1, None), ("ragged-n200-k700", 1000, 700, 200, 4, 4, None),
            ("skip-c1-real", 2560, 2560, 16, 1, 2, "real"), ("skip-c1-hand", 2560, 2560, 16, 1, 2, "hand"),
            ("skip-ragged-real", 2300, 520, 40, 3, 2, "real"), ("skip-ragged-hand", 2300, 520, 40, 3, 2, "hand")]
    return [(gid, dict(m=m, k=k, n=n, a_bits=ab, b_bits=bb, tile_map=tm, seed=400 + 11 * i))
            for i, (gid, m, k, n, ab, bb, tm) in enumerate(rows)]


def k3_plans(a, b, tile_map=None):
    """Every launch the tests force for these DigitTensors: the chosen
    plan, each column tile and each tile height on the chosen rest;
    duplicates left out."""
    from qgtc_ppopp22_tpu_torch.ops import digitmm

    args = (a.ndigits, b.ndigits, a.padded_rows, a.padded_cols, b.digits.shape[2], a.shape[1], b.shape[1],
            None if tile_map is None else tile_map.tile_k)
    chosen = digitmm.digitmm_plan(*args)
    tries = [{}] + [dict(bnt=t, rows=chosen.rows) for t in digitmm.K3_BNTS]
    tries += [dict(rows=r) for r in digitmm.K3_ROWS]
    plans = []
    for kw in tries:
        p = digitmm.digitmm_plan(*args, **kw)
        if p not in plans:
            plans.append(p)
    return plans


def k3_group(device, m, k, n, a_bits, b_bits, tile_map, seed):
    """The (tag, kernel, plain) calls of one :func:`k3_groups` entry: every
    out form of :data:`K3_FORMS` (digits at ``b_bits``, shift 1) under
    every plan of :func:`k3_plans` through ``digitmm._digitmm(...,
    _plan=)``; plain computed once per form."""
    import functools

    import torch

    from qgtc_ppopp22_tpu_torch.ops import digitmm
    from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack

    if tile_map is None:
        qa, qb = operands(seed, m, k, n, a_bits, b_bits, b_bits, 1)
    else:
        qa, qb = blocky_levels(seed, m, k, a_bits, 0.05), operands(seed, m, k, n, a_bits, b_bits, 2, 0)[1]
    a, b = (digit_pack(torch.from_numpy(q).to(device), bits) for q, bits in ((qa, a_bits), (qb, b_bits)))
    tm = None
    if tile_map is not None:
        tm = digitmm.build_tile_map_digits(a)
        tm = hand_map(tm) if tile_map == "hand" else tm
    calls = []
    for form, shift in K3_FORMS:
        ob = b_bits if form == "digits" else None
        raw = form == "i32"
        plain = functools.cache(lambda ob=ob, sh=shift, raw=raw: digitmm.digitmm_plain(a, b, ob, sh, raw, tm))
        for p in k3_plans(a, b, tm):
            tag = f"K3 {a_bits}x{b_bits} M={m} K={k} N={n} {form} map={tile_map} {p}"
            calls.append((tag, lambda ob=ob, sh=shift, raw=raw, p=p: digitmm._digitmm(a, b, ob, sh, raw, tm, _plan=p),
                          plain))
    return calls
