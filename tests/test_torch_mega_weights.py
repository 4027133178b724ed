"""K1's weight operands built once per staging, not once per launch.

``fused_model.pack_mega_weights`` builds the weights' blob (and, for the
signed chain, their correction rows) once; ``QGTCEngine._stage_mega`` builds
it once for each form its buckets take and passes it to every launch as
``packed=``; a launch given operands of another form or other widths
refuses them. On the CPU each launch runs the plain version, which checks
``packed`` the same way. Operands from ``torch_cases.mega_case``; logits
compared exactly.
"""

import numpy as np
import pytest
import torch

from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, synthesize
from qgtc_ppopp22_tpu_torch.ops import fused_model
from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack
from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine
from torch_cases import levels_plane, mega_case
from torch_threads import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

# form -> (bits, levels-form X, hidden): hidden 128 leaves no weight a free
# padded lane, so 8-bit levels take the split chain there
FORMS = {"digits": (2, False, 16), "signed": (8, True, 16), "split": (8, True, 128)}


def _operands(form, hidden=None, seed=31):
    bits, levels, wide = FORMS[form]
    _, _, qws, aw, xd = mega_case(seed, 2, 512, bits, hidden or wide, feat=100)
    x = levels_plane(xd) if levels else xd
    ws = [digit_pack(torch.from_numpy(w), bits) for w in qws]
    kw = dict(out_cols=40, x_levels_bits=bits if levels else None)
    return torch.from_numpy(aw), torch.from_numpy(x), ws, bits, kw


@pytest.mark.parametrize("bits,form", [(2, "digits"), (8, "signed")])
def test_stage_mega_builds_the_weights_once(monkeypatch, bits, form):
    """Three mega epochs over several buckets: one build of the weights'
    operands, the same object given to every bucket's launch."""
    built = []

    def counted(ws, f):
        built.append(f)
        return pack(ws, f)

    pack = fused_model.pack_mega_weights
    monkeypatch.setattr(fused_model, "pack_mega_weights", counted)
    ds = synthesize("Proteins", scale=0.04, seed=7)
    it = ClusterBatcher(ds, 12, 3, bit_width=bits, bucket_rows=256, shuffle=False)  # buckets 512 and 768
    eng = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes, bit_width=bits, device="cpu")
    staged = eng._stage_mega(it)
    assert len(staged) >= 2 and {bk["form"] for bk in eng.mega_buckets} == {form}
    assert len({id(fn.keywords["packed"]) for _, fn in staged}) == 1 and built == [form]
    eng.run_epochs_mega(it, n_epochs=3)
    assert built == [form, form]  # run_epochs_mega's own staging, once
    assert staged[0][1].keywords["packed"].form == ("signed" if form == "signed" else "digits")


@pytest.mark.parametrize("form", list(FORMS))
def test_packed_equals_built_per_launch(form):
    a, x, ws, bits, kw = _operands(form)
    p = fused_model.plan(a.shape, x.shape, ws, bits, "gcn", None, 40, x_levels_bits=kw["x_levels_bits"])
    assert p.form == form
    packed = fused_model.pack_mega_weights(ws, p.form)
    got = fused_model.fused_model_epoch(a, x, ws, bits, packed=packed, **kw)
    assert torch.equal(got, fused_model.fused_model_epoch(a, x, ws, bits, **kw))
    assert torch.equal(got, fused_model.fused_model_epoch_plain(a, x, ws, bits, **kw))
    if form == "signed":
        planes, corrs = fused_model.signed_weights(ws)
        assert torch.equal(packed.corr, torch.cat(corrs))
        assert packed.c_offs == np.cumsum([0] + [c.numel() for c in corrs[:-1]]).tolist()
    else:
        planes = [w.digits for w in ws]
        assert packed.corr is None
    assert torch.equal(packed.blob, torch.cat([t.reshape(-1) for t in planes]))
    assert packed.offs == np.cumsum([0] + [t.numel() for t in planes[:-1]]).tolist()


@pytest.mark.parametrize("form,other", [("digits", "signed"), ("signed", "digits"), ("split", "signed")])
def test_packed_of_another_form_refused(form, other):
    a, x, ws, bits, kw = _operands(form)
    with pytest.raises(ValueError, match="packed weights of form"):
        fused_model.fused_model_epoch(a, x, ws, bits, packed=fused_model.pack_mega_weights(ws, other), **kw)


@pytest.mark.parametrize("form", ["digits", "signed"])
def test_packed_of_other_widths_refused(form):
    a, x, ws, bits, kw = _operands(form)
    other = _operands(form, hidden=32)[2]
    with pytest.raises(ValueError, match="this launch needs"):
        fused_model.fused_model_epoch(a, x, ws, bits, packed=fused_model.pack_mega_weights(other, form), **kw)
