"""K1's levels form at 1-4 bits (``fused_model_epoch(x_levels_bits=1..4)``)
against the JAX ``fused_model_epoch`` in Pallas interpret mode, which takes
any width (``ops/fused_model.py:426-465``): the offset-signed chain where
every weight has a free padded lane (hidden 16), else the split form with
one digit masked to the bits (hidden 128: JAX's ``x_split``). GCN and GIN,
dense and block-scheduled, linear-range data from ``tests/torch_cases.py``.
The port's CPU path is the kernel's plain version. Tolerance: exact
equality on the stored columns (``out_cols`` 40: JAX's signed kernel keeps
its ones-lane bookkeeping in the last padded column).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu.ops import digits as jdigits
from qgtc_ppopp22_tpu.ops.fused_model import fused_model_epoch as jax_fused_model_epoch
from qgtc_ppopp22_tpu_torch.ops import digits, fused_model
from qgtc_ppopp22_tpu_torch.runtime import mega_block_sched
from torch_cases import levels_plane, mega_case
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

SHIFTS = [1, 2, 1, 2, 1]


@pytest.mark.parametrize("bits,sched", [(1, False), (2, False), (2, True), (4, False)])
@pytest.mark.parametrize("hidden", [16, 128])  # the signed form, the split form
@pytest.mark.parametrize("model", ["gcn", "gin"])
def test_levels_form_low_bits_matches_jax(model, bits, hidden, sched):
    keep = [[[1]]] if sched else None  # column block 0 of the row chunk left out
    shifts = SHIFTS if bits > 1 else None  # 1-bit levels saturate under shifts
    qa, qx, qws, aw, xd = mega_case(bits + hidden + 7 * sched, 1, 512, bits, hidden, keep=keep,
                                    shift=1 if shifts else 0)
    assert xd.shape[1] == 1  # one digit plane: the levels themselves
    xl = levels_plane(xd)
    ws = [digits.digit_pack(torch.from_numpy(w), bits) for w in qws]
    jws = [jdigits.digit_pack(jnp.asarray(w), bits) for w in qws]
    p = fused_model.plan(aw.shape, xl.shape, ws, bits, model, shifts, 40, x_levels_bits=bits)
    assert (p.form, p.nd_x, p.x_bits) == ("signed" if hidden == 16 else "split", 1, bits)
    blk = np.stack([mega_block_sched(w[None], 512, 256) for w in aw]) if sched else None
    kw = dict(model=model, shifts=shifts, out_cols=40, x_cols=128, x_levels_bits=bits)
    got = fused_model.fused_model_epoch(torch.from_numpy(aw), torch.from_numpy(xl), ws, bits,
                                        blk_sched=None if blk is None else torch.from_numpy(blk), **kw)
    ref = np.asarray(jax_fused_model_epoch(jnp.asarray(aw), jnp.asarray(xl), jws, bits,
                                           blk_sched=None if blk is None else jnp.asarray(blk), **kw))
    assert got.shape == ref.shape == (1, 512, 40)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > 4  # neither saturated nor vanished
    # the same logits as the digit-plane route on the same levels
    dkw = dict(kw, x_levels_bits=None)
    assert torch.equal(got, fused_model.fused_model_epoch(torch.from_numpy(aw), torch.from_numpy(xd), ws,
                                                          bits, blk_sched=None if blk is None
                                                          else torch.from_numpy(blk), **dkw))


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_levels_split_masks_the_bytes_to_the_bits(bits):
    """The split form keeps the low ``bits`` of each byte (JAX's mask);
    the signed form takes the whole byte, as JAX's signed kernel does."""
    _, _, qws, aw, xd = mega_case(bits, 1, 512, bits, 128, shift=1)
    xl = levels_plane(xd)
    noisy = (xl.view(np.uint8) | np.uint8(0xFF ^ ((1 << bits) - 1))).view(np.int8)  # every higher bit set
    ws = [digits.digit_pack(torch.from_numpy(w), bits) for w in qws]
    kw = dict(model="gcn", out_cols=40, x_levels_bits=bits)
    clean = fused_model.fused_model_epoch(torch.from_numpy(aw), torch.from_numpy(xl), ws, bits, **kw)
    assert torch.equal(clean, fused_model.fused_model_epoch(torch.from_numpy(aw), torch.from_numpy(noisy),
                                                            ws, bits, **kw))
    jws = [jdigits.digit_pack(jnp.asarray(w), bits) for w in qws]
    ref = np.asarray(jax_fused_model_epoch(jnp.asarray(aw), jnp.asarray(noisy), jws, bits, **kw))
    np.testing.assert_array_equal(clean.numpy(), ref)
