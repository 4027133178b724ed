#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs, and stops with a non-zero exit at the first failure:

0. Requires a CUDA device; prints the card's name and power limit;
   builds the kernels of ``qgtc_ppopp22_tpu_torch/csrc`` with nvcc.
1. Each kernel against its plain PyTorch version on the same CUDA
   tensors, at 1/2/4/8 bits, shifts 0 and 2, the slice's shapes
   (pn = 2560, K in {128, 2560}, N in {16, 40}) and one ragged
   multi-tile shape, plus operands built so that the accumulator hits
   every requantize edge (0, 2^b - 1, 2^b, 2^b + 1). Equality must be
   exact, padded outputs included.
2. The main path: 2-bit 3-layer Cluster-GCN (hidden 16) on the
   full-scale synthetic ogbn-arxiv stand-in, psize 1500, batch 20, 75
   batches, through ``QGTCEngine.forward_all``; launch counts are reset
   just before and must show 3 packmm + 3 digitmm launches per batch;
   logits must equal the plain versions' and, for the first batch, a
   NumPy integer reference. Then 4 batches of 2-bit GIN (hidden 64).
3. Timing: ms/epoch of the step engine (host clock around all epochs
   and one synchronize, resident and transfer-inclusive, twice each),
   and the device time of each kernel beside its plain version at the
   slice's shapes (torch.profiler).

Test operands come from ``tests/torch_cases.py``. The second line from
the end is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    from torch_cases import edge_operands, operands
    from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset
    from qgtc_ppopp22_tpu_torch.ops import _build, digitmm, packmm
    from qgtc_ppopp22_tpu_torch.ops.bitpack import unpack_bits
    from qgtc_ppopp22_tpu_torch.ops.digits import digit_levels, digit_pack, digit_unpack
    from qgtc_ppopp22_tpu_torch.ops.packmm import pack_rows, packed_levels
    from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine
    from qgtc_ppopp22_tpu_torch.utils.timing import device_times_ms

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")

    # -- phase 0: build -------------------------------------------------
    secs, report = _build.build()
    _build.library()
    print(f"phase 0: built {_build.LIB_PATH.name} in {secs:.1f} s")
    entry = ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            entry = entry[entry.find("gemm_kernel"):][:60]
        elif "Used" in line:
            print(f"  ptxas: {entry}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill"):
            print(f"  ptxas: {entry}: {line.strip()}")

    # -- phase 1: kernel vs plain --------------------------------------
    err = {"packmm": 0.0, "digitmm": 0.0}
    ncase = {"packmm": 0, "digitmm": 0}

    def compare(kind, got, want, what):
        if hasattr(got, "digits"):
            if got.shape != want.shape or got.digits.shape != want.digits.shape:
                raise AssertionError(f"{what}: container shapes differ")
            diff = (digit_levels(got) - digit_levels(want)).abs().max().item()
            same = torch.equal(got.digits, want.digits)
        else:
            if got.shape != want.shape:
                raise AssertionError(f"{what}: {tuple(got.shape)} vs {tuple(want.shape)}")
            diff = (got.double() - want.double()).abs().max().item()
            same = torch.equal(got, want)
        torch.cuda.synchronize()
        err[kind] = max(err[kind], diff)
        ncase[kind] += 1
        if not same:
            raise AssertionError(f"{what}: kernel != plain (max abs err {diff})")

    def check_pair(qa, qb, a_bits, b_bits, tag, shifts=(0, 2)):
        b = digit_pack(torch.from_numpy(qb).to(dev), b_bits)
        pa = pack_rows(torch.from_numpy(qa).to(dev), a_bits)
        da = digit_pack(torch.from_numpy(qa).to(dev), a_bits)
        for sh in shifts:
            compare("packmm", packmm.packmm_to_digits(pa, b, b_bits, shift=sh),
                    packmm.packmm_plain(pa, b, b_bits, sh), f"packmm_to_digits {tag} shift={sh}")
            compare("digitmm", digitmm.digitmm_to_digits(da, b, b_bits, shift=sh),
                    digitmm.digitmm_plain(da, b, b_bits, sh), f"digitmm_to_digits {tag} shift={sh}")
        compare("packmm", packmm.packmm_to_f32(pa, b), packmm.packmm_plain(pa, b), f"packmm_to_f32 {tag}")
        compare("digitmm", digitmm.digitmm_to_f32(da, b), digitmm.digitmm_plain(da, b), f"digitmm_to_f32 {tag}")

    t0 = time.perf_counter()
    shapes = [(2560, 128, 16), (2560, 2560, 16), (2560, 128, 40), (2560, 2560, 40), (1000, 700, 200)]
    for bits in (1, 2, 4, 8):
        for (M, K, N) in shapes:
            for sh in (0, 2):
                check_pair(*operands(SEED + M + K + N + sh, M, K, N, bits, bits, bits, sh), bits, bits,
                           f"bits={bits} M={M} K={K} N={N}", shifts=(sh,))
        # the slice's own pairing: 1-bit adjacency x bits-wide features
        check_pair(*operands(SEED + bits, 2560, 2560, 16, 1, bits, bits, 0), 1, bits,
                   f"1-bit A x {bits}-bit B")
        for sh in (0, 2):
            qa, qb = edge_operands(bits, sh)
            check_pair(qa, qb, bits, bits, f"requant edges bits={bits}", shifts=(sh,))
    print(f"phase 1: kernel == plain exactly in {ncase} cases "
          f"({time.perf_counter() - t0:.1f} s); max abs err {err}")

    # -- phase 2: the main path ----------------------------------------
    t0 = time.perf_counter()
    ds = load_dataset("ogbn-arxiv", data_dir="qgtc_graphs")
    batcher = ClusterBatcher(ds, psize=1500, batch_size=20, bit_width=2, seed=SEED,
                             cache_dir="./datasets")
    nb = len(batcher)
    print(f"phase 2: {ds.name} {ds.num_nodes} nodes {ds.graph.num_edges} edges, "
          f"{nb} batches, buckets {batcher.buckets()}, host pipeline "
          f"{time.perf_counter() - t0:.1f} s")
    if nb != 75:
        raise AssertionError(f"expected 75 batches, got {nb}")
    eng = QGTCEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="gcn",
                     bit_width=2, seed=SEED, device=dev)
    eng.warmup(batcher)
    packmm.LAUNCHES = 0
    digitmm.LAUNCHES = 0
    logits = eng.forward_all(batcher)
    torch.cuda.synchronize()
    launches = {"packmm": packmm.LAUNCHES, "digitmm": digitmm.LAUNCHES}
    if launches != {"packmm": 3 * nb, "digitmm": 3 * nb}:
        raise AssertionError(f"main path launches {launches}, want 3 each per batch")
    ref = eng.forward_all(batcher, plain=True)
    for b, got, want in zip(batcher.batches, logits, ref):
        if got.shape != (b.padded_nodes, ds.num_classes) or not torch.isfinite(got).all():
            raise AssertionError(f"bad logits {tuple(got.shape)}")
        n = b.num_nodes
        if not torch.equal(got[:n, :ds.num_classes], want[:n, :ds.num_classes]):
            raise AssertionError("main path: kernel logits != plain logits")
    # independent NumPy integer reference for the first batch
    b0 = batcher.batches[0]
    a_lv = packed_levels(eng.put_batch(b0)[0]).cpu().numpy().astype(np.int64)
    h = unpack_bits(b0.bit_X).numpy().astype(np.int64)
    ws = [digit_unpack(w).cpu().numpy().astype(np.int64) for w in eng.weights]

    def requant(acc):
        return np.where(acc > 4, 3, np.where(acc < 0, 1, acc)) & 3

    for i, w in enumerate(ws):
        h = requant(h @ w)
        if i < len(ws) - 1:
            h = requant(a_lv[:, : h.shape[0]] @ h)
    golden = (a_lv[:, : h.shape[0]] @ h).astype(np.float32)
    if not np.array_equal(logits[0].cpu().numpy(), golden[: b0.padded_nodes]):
        raise AssertionError("main path: batch 0 logits != NumPy integer reference")
    nz = sum(int((lg[:bb.num_nodes] != 0).sum()) for lg, bb in zip(logits, batcher.batches))
    print(f"phase 2: GCN logits of {nb} batches == plain == NumPy reference (batch 0); "
          f"launches {launches}; nonzero logits {nz}; "
          f"accuracy {eng.evaluate(batcher, ds.labels):.4f}")

    gin = QGTCEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="gin",
                     bit_width=2, seed=SEED, device=dev)
    packmm.LAUNCHES = 0
    digitmm.LAUNCHES = 0
    gl = [gin.forward_batch(b) for b in batcher.batches[:4]]
    torch.cuda.synchronize()
    gin_launches = {"packmm": packmm.LAUNCHES, "digitmm": digitmm.LAUNCHES}
    if gin_launches != {"packmm": 12, "digitmm": 12}:
        raise AssertionError(f"GIN launches {gin_launches}")
    for b, got in zip(batcher.batches[:4], gl):
        want = gin.forward_batch(b, plain=True)
        n = b.num_nodes
        if not torch.equal(got[:n, :ds.num_classes], want[:n, :ds.num_classes]):
            raise AssertionError("GIN: kernel logits != plain logits")
    print(f"phase 2: GIN (hidden 64) logits of 4 batches == plain; launches {gin_launches}")

    # -- phase 3: timing ------------------------------------------------
    for rep in range(2):
        for resident in (True, False):
            st = eng.run_epochs(batcher, n_epochs=5, resident=resident)
            print(f"phase 3: step engine GCN 2-bit arxiv, resident={resident}: "
                  f"{st.avg_ms:.3f} ms/epoch over {st.n_batches} batches [{card}]")
    def on_card(q, bits, packed=False):
        t = torch.from_numpy(q).to(dev)
        return pack_rows(t, bits) if packed else digit_pack(t, bits)

    qa, qh16 = operands(SEED, 2560, 2560, 16, 1, 2, 2, 0)
    qx, qw1 = operands(SEED, 2560, 128, 16, 2, 2, 2, 0)
    a, h16, x, w1 = on_card(qa, 1, True), on_card(qh16, 2), on_card(qx, 2), on_card(qw1, 2)
    h40 = on_card(operands(SEED, 2560, 2560, 40, 1, 2, 2, 0)[1], 2)
    w2 = on_card(operands(SEED, 16, 16, 16, 2, 2, 2, 0)[1], 2)
    timed = [
        ("packmm", "packmm_to_digits A[2560x2560] x H[2560x16]",
         lambda: packmm.packmm_to_digits(a, h16, 2), lambda: packmm.packmm_plain(a, h16, 2)),
        ("packmm", "packmm_to_f32 A[2560x2560] x H[2560x40]",
         lambda: packmm.packmm_to_f32(a, h40), lambda: packmm.packmm_plain(a, h40)),
        ("digitmm", "digitmm_to_digits X[2560x128] x W[128x16]",
         lambda: digitmm.digitmm_to_digits(x, w1, 2), lambda: digitmm.digitmm_plain(x, w1, 2)),
        ("digitmm", "digitmm_to_digits H[2560x16] x W[16x16]",
         lambda: digitmm.digitmm_to_digits(h16, w2, 2), lambda: digitmm.digitmm_plain(h16, w2, 2)),
    ]
    # device time per call from one profiler session, in turns:
    # plain, kernel, kernel, plain
    fns = {}
    for i, (_, what, kern, plain) in enumerate(timed):
        fns.update({(i, "plain", 0): plain, (i, "kernel", 0): kern,
                    (i, "kernel", 1): kern, (i, "plain", 1): plain})
    dt = device_times_ms(fns)
    times = {}
    for i, (kind, what, _, _) in enumerate(timed):
        k_ms = min(dt[(i, "kernel", 0)], dt[(i, "kernel", 1)])
        p_ms = min(dt[(i, "plain", 0)], dt[(i, "plain", 1)])
        times.setdefault(kind, (k_ms, p_ms))
        print(f"phase 3: {what}: kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us "
              f"device time per call (2-bit, N padded to 128) [{card}]")

    kernels = [
        {"name": "packmm", "route": "cuda", "source": "qgtc_ppopp22_tpu_torch/csrc/packmm.cu",
         "replaces": "qgtc_ppopp22_tpu/ops/packmm.py:664", "launches": launches["packmm"],
         "max_abs_err": err["packmm"], "ms": times["packmm"][0], "plain_ms": times["packmm"][1]},
        {"name": "digitmm", "route": "cuda", "source": "qgtc_ppopp22_tpu_torch/csrc/digitmm.cu",
         "replaces": "qgtc_ppopp22_tpu/ops/digitmm.py:193", "launches": launches["digitmm"],
         "max_abs_err": err["digitmm"], "ms": times["digitmm"][0], "plain_ms": times["digitmm"][1]},
    ]
    print(card)  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
