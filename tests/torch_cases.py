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
