"""Zero-tile study: the all-zero share of each dataset's adjacency tiles,
and dense against zero-tile epochs.

    python -m qgtc_ppopp22_tpu_torch.benchmarks.zero_tile_study --datasets Proteins artist \\
        [--modes fused mega mega-streaming] [--device cuda|cpu] [--csv F]

The counterpart of the JAX repository's ``benchmarks/zero_tile_study.py``
(the reference's ``4_8_zero_tile_jumping.py`` and its tile counters,
``kernel.h:394-648``). For each dataset the counts come from the pack-time
maps, with no device work: ``tiles_total`` / ``tiles_processed``, the
256 x 256 K tiles of every batch's ``tile_kidx`` / the tiles its
``tile_kcnt`` lists (the step and fused engines' K skip); the share of row
chunks (``runtime.mega_chunk_occ``, the streaming tier's ``chunk_occ``) and
of (row chunk x ``fused_model.mega_colblock``) blocks
(``runtime.mega_block_occ``, the compacted schedule) that are all zero.
Then, for each mode, host ms/epoch with ``zerotile_jump`` False (dense) and
True (zero-tile):

* ``fused``: E5 against E5z, the captured epoch of K2 and K3 with and
  without each batch's ``TileMap``;
* ``mega``: ``run_epochs_mega``, K1 dense against its compacted block
  schedule;
* ``mega-streaming``: ``run_epochs_mega(resident_a=False)``, K1 dense
  against the ``chunk_occ`` tier;
* ``step``: ``run_epochs(resident=True)`` with and without the maps.

Every row carries ``card``. No CSV is written unless asked
(``results/zero_tile.csv`` holds the JAX package's TPU rows). Runs on the
card (``--device cuda``, the default) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from qgtc_ppopp22_tpu_torch.bench import study_device
from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset
from qgtc_ppopp22_tpu_torch.graph.datasets import DEFAULT_PSIZE
from qgtc_ppopp22_tpu_torch.ops.fused_model import mega_colblock
from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine, mega_block_occ, mega_chunk_occ
from qgtc_ppopp22_tpu_torch.utils.metrics import write_csv

DATASETS = ("Proteins", "artist", "soc-BlogCatalog", "ppi", "ogbn-arxiv")
MODES = ("fused", "mega", "mega-streaming", "step")


def tile_counts(batcher: ClusterBatcher) -> dict:
    """The batcher's tile counters from its pack-time maps (host only):
    K tiles total and listed, and the all-zero shares of K tiles, of K1's
    row chunks and of its 2-D blocks."""
    total = processed = chunks_total = chunks_occ = blocks_total = blocks_occ = 0
    for b in batcher.batches:
        total += b.tile_kidx.numel()
        processed += int(b.tile_kcnt.sum())
        pn, words = b.padded_nodes, b.a_words.numpy()
        chunk = 512 if pn % 512 == 0 else 256
        occ = mega_chunk_occ(words, chunk)
        chunks_total += occ.size
        chunks_occ += int(occ.sum())
        bocc = mega_block_occ(words, chunk, mega_colblock(pn))
        blocks_total += bocc.size
        blocks_occ += int(bocc.sum())
    return dict(tiles_total=total, tiles_processed=processed,
                jump_ratio=round(1 - processed / max(total, 1), 4),
                chunk_jump_ratio=round(1 - chunks_occ / max(chunks_total, 1), 4),
                block_jump_ratio=round(1 - blocks_occ / max(blocks_total, 1), 4))


def mode_ms(batcher: ClusterBatcher, num_classes: int, mode: str, zerotile_jump: bool, bit_width: int,
            n_epochs: int, device) -> float:
    """Host ms/epoch of ``mode`` (:data:`MODES`) with ``zerotile_jump``."""
    eng = QGTCEngine(feat_dim=batcher.feat_dim, num_classes=num_classes, bit_width=bit_width,
                     zerotile_jump=zerotile_jump, device=device)
    if mode == "mega":
        st = eng.run_epochs_mega(batcher, n_epochs=n_epochs)
    elif mode == "mega-streaming":
        st = eng.run_epochs_mega(batcher, n_epochs=n_epochs, resident_a=False)
    elif mode == "fused":
        st = eng.run_epochs_fused(batcher, n_epochs=n_epochs)
    elif mode == "step":
        st = eng.run_epochs(batcher, n_epochs=n_epochs, resident=True)
    else:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    return st.avg_ms


def dataset_rows(name: str, batcher: ClusterBatcher, num_classes: int, modes: Sequence[str], n_epochs: int,
                 device, card: str) -> list:
    """One row per mode for one dataset's batcher."""
    counts = tile_counts(batcher)
    out = []
    for mode in modes:
        times = {zt: mode_ms(batcher, num_classes, mode, zt, batcher.bit_width, n_epochs, device)
                 for zt in (False, True)}
        out.append(dict(dataset=name, psize=batcher.psize, mode=mode, tile="256x256", **counts,
                        dense_ms=round(times[False], 3), zerotile_ms=round(times[True], 3),
                        speedup=round(times[False] / max(times[True], 1e-9), 3), card=card))
        print(out[-1], flush=True)
    return out


def rows(datasets: Sequence[str] = DATASETS, modes: Sequence[str] = ("fused", "mega", "mega-streaming"),
         psize: Optional[int] = None, batch_size: int = 20, bit_width: int = 2, n_epochs: int = 20,
         scale: float = 1.0, device="cuda", csv: Optional[str] = None) -> list:
    dev, card = study_device(device)
    out = []
    for name in datasets:
        ds = load_dataset(name, scale=scale)
        it = ClusterBatcher(ds, psize=psize or DEFAULT_PSIZE.get(name, 1500), batch_size=batch_size,
                            bit_width=bit_width, cache_dir="./datasets")
        out += dataset_rows(name, it, ds.num_classes, modes, n_epochs, dev, card)
        if csv:  # incremental: a later dataset that dies leaves the finished rows
            write_csv(csv, out, list(out[0]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--datasets", nargs="+", default=list(DATASETS))
    p.add_argument("--psize", type=int, default=None,
                   help="partition count (default: 1500, or the per-dataset override for very large graphs)")
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--bit_width", type=int, default=2)
    p.add_argument("--n-epochs", type=int, default=20)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--modes", nargs="+", choices=MODES, default=["fused", "mega", "mega-streaming"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--csv", default=None)
    args = p.parse_args(argv)
    rows(args.datasets, args.modes, args.psize, args.batch_size, args.bit_width, args.n_epochs, args.scale,
         args.device, args.csv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
