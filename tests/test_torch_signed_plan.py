"""K4's launch plan (``ops/packmm.packmm_signed_plan``, for a 5-8-bit A:
the PreparedRHS product and K2's 8-bit plane) at the kernel sweep's nine
8-bit shapes and at every shape and form ``tests/torch_cases.k4_groups``
forces on the card; and the plain versions the card's kernel is held to
(``packmm_signed_plain``, ``packmm_plain``) against the JAX package's
``_packmm_signed_stream`` and ``_packmm`` in Pallas interpret mode at
those groups' shapes.

Tolerance: exact equality, whole containers padding included (integer
arithmetic; float32 outputs are the same integers rounded once). The
port's operands are cut to the groups' padded depth (448, 7 K steps), the
JAX ones keep their own (512): the product of the levels is the same.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu.ops import bitgemm as jbitgemm
from qgtc_ppopp22_tpu.ops import digits as jdigits
from qgtc_ppopp22_tpu.ops import packmm as jpackmm
from qgtc_ppopp22_tpu_torch.ops import packmm
from qgtc_ppopp22_tpu_torch.ops.bitpack import round_up
from qgtc_ppopp22_tpu_torch.ops.packmm import packmm_signed_plan
from tests.torch_cases import K2_FORMS, K4_FORMS, hand_map, k4_groups, k4_levels, k4_operands
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

GROUPS = k4_groups()


@pytest.mark.parametrize("mk", [1024, 2048, 4096])
@pytest.mark.parametrize("n", [16, 32, 64])
def test_plan_at_the_sweep_8bit_rows(mk, n):
    """Fig. 8a's 8-bit rows (``out_cols`` N of 128 lanes, nothing masked):
    one column tile as wide as N, so A is read once; the split fills
    three quarters of the SMs: 3 CTAs an output tile at 4096², 4 below."""
    a, bp = k4_operands(n, 256, 256, n, 8, 8, "cpu")
    ocp, mask_n = packmm._signed_stores(a, bp, 8, "packed", n)
    assert (ocp, mask_n) == (n, 128)
    p = packmm_signed_plan(mk, mk, 128, mask_n, "plane", ocp)
    s = 3 if mk == 4096 else 4  # clusters that place in one wave: 96 CTAs at 4096²
    assert (p.bnt, p.splits, p.cluster, p.grid) == (n, s, (1, 1, s), (1, mk // 128, s))
    assert p.grid[0] * p.grid[1] * p.splits <= packmm.SIGNED_RESIDENT


def _group_forms(kw):
    """(out_bits, out_form, raw, out_cols) of each form a group runs."""
    prepared = kw.get("prepared", True)
    if kw.get("out_cols") is not None:
        forms = [(ob, "packed", False, kw["out_cols"]) for ob in (1, 2, 4, 8)]
        return forms + ([(None, "f32", False, kw["out_cols"])] if prepared else [])
    return [(ob, f, r, kw["n"] if oc == "n" else oc) for ob, f, _, r, oc in (K4_FORMS if prepared else K2_FORMS)]


@pytest.mark.parametrize("group", [kw for _, kw in GROUPS], ids=[gid for gid, _ in GROUPS])
def test_plan_of_each_group(group):
    """The plan the wrapper takes for each form: only column tiles that
    hold computed columns (below round_up(n, 8) and the stored width,
    nothing of padding only), on the narrowest tile that holds them; the
    split within its bounds and filling the card; packed words on clusters
    of the two 128-row CTAs of a 256-row group."""
    kw = dict(group, m=min(group["m"], 256), k=min(group["k"], 448))  # the extents the plan reads, cut
    a, b = k4_operands(**{k: v for k, v in kw.items() if k not in ("hand", "out_cols")}, device="cpu")
    mp, kp = group["m"] + -group["m"] % 256, group.get("kp") or round_up(group["k"], 128)
    tm = None
    if group.get("hand"):
        tm = packmm.build_tile_map_packed(
            packmm.PackedTensor(words=torch.full((1, mp, kp), -128, dtype=torch.int8), shape=(mp, kp), bits=8),
            256, 128)
    for out_bits, form, raw, out_cols in _group_forms(group):
        pform = packmm._plan_form(out_bits, form, raw)
        if group.get("prepared", True):
            ocp, n = packmm._signed_stores(a, b, out_bits, form, out_cols)
            np_ = b.plane.shape[1]
        else:
            np_ = b.padded_cols
            ocp, n = packmm._stored_cols(form, out_cols, np_), group["n"]
        p = packmm_signed_plan(mp, kp, np_, n, pform, ocp, tm)
        width = np_ if pform == "digits" else ocp
        need = min(round_up(n, 8), width)
        assert p.grid[0] * p.bnt >= need > (p.grid[0] - 1) * p.bnt, (form, out_cols)
        assert p.bnt == next(t for t in (16, 32, 64) if need <= t or t == 64)
        assert p.grid[0] * p.bnt <= np_ and p.grid[1] * packmm.SIGNED_ROWS == mp
        words = pform == "words"
        assert p.grid[2] == p.cluster[2] == p.splits and p.cluster[:2] == (1, 2 if words else 1)
        steps = -(-kp // packmm.SIGNED_STEP) // 2 if tm is None else kp // 128
        ctas = p.grid[0] * p.grid[1]
        assert p.splits == max(1, min(packmm.PACK_SPLIT if words else packmm.MAX_SPLIT,
                                      packmm.SIGNED_RESIDENT // ctas, steps))


def test_plan_is_computed_once_per_shape_and_refuses_an_unknown_form():
    assert packmm_signed_plan(4096, 4096, 128, 128, "plane", 64) is packmm_signed_plan(4096, 4096, 128, 128,
                                                                                     "plane", 64)
    with pytest.raises(ValueError, match="out_form"):
        packmm_signed_plan(256, 256, 128, 16, "packed", 128)


def test_forced_plan_on_cpu_runs_plain():
    """``_plan`` only picks the card's launch: CPU tensors run plain."""
    a, bp = k4_operands(3, 300, 200, 24, 8, 8, "cpu")
    plan = packmm_signed_plan(a.padded_rows, a.padded_cols, 128, 24, "f32", 128)
    forced = dataclasses.replace(plan, bnt=64, splits=3, cluster=(1, 1, 3), grid=(1, plan.grid[1], 3))
    got = packmm._packmm(a, bp, None, "f32", 0, False, _plan=forced)
    assert torch.equal(got, packmm.packmm_signed_plain(a, bp))


# -- plain against JAX at the groups' shapes --------------------------------


def _payload(out):
    for name in ("words", "digits"):
        if hasattr(out, name):
            return getattr(out, name)
    return out


def _same(got, ref):
    g, r = _payload(got), np.asarray(_payload(ref))
    assert g.numpy().dtype == r.dtype and tuple(g.shape) == r.shape
    np.testing.assert_array_equal(g.numpy(), r)


def _call(lib, a, b, out_bits, form, shift, raw, out_cols, tile_map=None):
    if out_bits is None:
        if raw:
            return lib.packmm_to_i32(a, b, tile_map=tile_map)
        return lib.packmm_to_f32(a, b, tile_map=tile_map, out_cols=out_cols)
    if form == "digits":
        return lib.packmm_to_digits(a, b, out_bits, tile_map=tile_map, shift=shift)
    return lib.packmm_to_packed(a, b, out_bits, tile_map=tile_map, shift=shift, out_cols=out_cols)


@functools.lru_cache(maxsize=None)
def _jax_operands(gid):
    kw = dict(GROUPS)[gid]
    qa, qb = k4_levels(kw["seed"], kw["m"], kw["k"], kw["n"], kw["a_bits"], kw["b_bits"], kw.get("data", "random"),
                       kw.get("hand", False))
    ja = jpackmm.pack_rows(jnp.asarray(qa), kw["a_bits"])
    jb = jdigits.digit_pack(jnp.asarray(qb), kw["b_bits"])
    if kw.get("prepared", True):
        jb = jpackmm.prepare_rhs(jb)
    return ja, jb


# (group, form): out_cols -1 stands for N; a few forms of each group, so
# that JAX's interpret mode stays within half a minute
JAX_CASES = [
    ("prepared-n16-a8", (8, "packed", 0, False, -1)), ("prepared-n16-a8", (None, "f32", 0, False, None)),
    ("prepared-n60-a8", (2, "packed", 0, False, -1)), ("prepared-n60-a8", (2, "digits", 1, False, None)),
    ("prepared-n64-a8", (8, "packed", 0, False, None)), ("prepared-n64-a8", (None, "f32", 0, True, None)),
    ("prepared-n120-a8", (4, "packed", 1, False, -1)), ("prepared-n120-a8", (None, "f32", 0, False, -1)),
    ("prepared-n60-a5", (5, "packed", 2, False, -1)), ("prepared-n60-a5", (8, "digits", 0, False, None)),
    ("prepared-oc8", (1, "packed", 0, False, 8)), ("prepared-oc40", (8, "packed", 0, False, 40)),
    ("prepared-oc64", (2, "packed", 0, False, 64)), ("prepared-oc200", (None, "f32", 0, False, 200)),
    ("prepared-a0", (8, "packed", 0, False, -1)), ("prepared-top", (None, "f32", 0, True, None)),
    ("planes-n16-b4", (2, "digits", 1, False, None)), ("planes-n16-b8", (1, "packed", 0, False, -1)),
    ("planes-n60-b4", (8, "packed", 0, False, -1)), ("planes-n60-b8", (None, "f32", 0, False, -1)),
    ("planes-n120-a5", (4, "packed", 0, False, -1)), ("planes-oc8", (2, "packed", 0, False, 8)),
    ("planes-oc200", (8, "packed", 0, False, 200)),
]


@pytest.mark.parametrize("gid,form", JAX_CASES, ids=[f"{g}-{f[0]}-{f[1]}-{f[4]}" for g, f in JAX_CASES])
def test_plain_matches_jax_at_the_group_shapes(gid, form):
    kw = dict(GROUPS)[gid]
    out_bits, out_form, shift, raw, oc = form
    oc = kw["n"] if oc == -1 else oc
    args = {k: v for k, v in kw.items() if k not in ("hand", "out_cols")}
    a, b = k4_operands(**args, device="cpu")
    ja, jb = _jax_operands(gid)
    got = packmm.packmm_plain(a, b, out_bits, shift, raw, out_form, oc)
    _same(got, _call(jpackmm, ja, jb, out_bits, out_form, shift, raw, oc))
    # what the wrapper runs on CPU tensors
    _same(_call(packmm, a, b, out_bits, out_form, shift, raw, oc), _call(jpackmm, ja, jb, out_bits, out_form,
                                                                         shift, raw, oc))


def _jax_map(tm):
    """``hand_map`` without the entries outside the grid (the TPU kernel
    leaves those undefined): a tile listed twice, kcnt 0, past the grid
    and -1 stay."""
    kidx = tm.kidx.clone()
    nk = kidx.shape[1]
    kidx[2, 0], kidx[2, 1 % nk] = 0, nk - 1
    return dataclasses.replace(tm, kidx=kidx)


@pytest.mark.parametrize("form", [(2, "digits", 1, False, None), (8, "packed", 0, False, -1)], ids=str)
@pytest.mark.parametrize("gid", ["planes-map-b4", "planes-map-b8"])
def test_plain_with_a_map_matches_jax(gid, form):
    """K2's 8-bit plane with a map: the colsum correction over the listed
    tiles only, each as often as it is listed."""
    kw = dict(GROUPS)[gid]
    out_bits, out_form, shift, raw, oc = form
    oc = kw["n"] if oc == -1 else oc
    a, b = k4_operands(**{k: v for k, v in kw.items() if k not in ("hand", "out_cols")}, device="cpu", blocky=True)
    tm = _jax_map(hand_map(packmm.build_tile_map_packed(a, 256, 128)))
    ja, jb = _jax_operands(gid)
    jtm = jbitgemm.TileMap(kidx=jnp.asarray(tm.kidx.numpy()), kcnt=jnp.asarray(tm.kcnt.numpy()), tile_m=256,
                           tile_k=128)
    got = packmm.packmm_plain(a, b, out_bits, shift, raw, out_form, oc, tm)
    _same(got, _call(jpackmm, ja, jb, out_bits, out_form, shift, raw, oc, jtm))
    assert not torch.equal(packmm.packmm_plain(a, b, raw_i32=True), packmm.packmm_plain(a, b, raw_i32=True,
                                                                                         tile_map=tm))
