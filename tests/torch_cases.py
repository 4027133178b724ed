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
