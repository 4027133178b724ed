"""The control of a cell's check: the program's own path one precision below
the configuration's, judged against the configuration's reference.

    python3 -m h100bench.control --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]

On the chip, at the cell's own size. For each seed, in one process: the
inputs, the program at the configuration's bit width through a short window
of epochs at the cell's load (the sound reading), then the same batches
re-quantized at one bit less (``ClusterBatcher.rebit``) through an engine of
that width with the same float weights (the control's reading), each
compared with the reference at the configuration's width. Prints one JSON
line a seed: the compared numbers of both beside the limits. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from h100bench import run, spec


def readings(cell: dict, seed: int, seconds: float, device: torch.device) -> dict:
    """The sound and the control's compared numbers for ``seed``."""
    data = run.inputs(cell, seed, device)
    entry = run.make_entry(cell, data, device)
    narrow = entry.batcher.rebit(int(cell["config"]["bit_width"]) - 1)
    sound = run.checked(cell, data, entry, run.window(entry.epoch, seconds, device, seed % run.KEEP_FROM)["outs"],
                        device)
    entry = run.make_entry(cell, data, device, bits=narrow.bit_width, batcher=narrow)
    control = run.checked(cell, data, entry, run.window(entry.epoch, seconds, device, seed % run.KEEP_FROM)["outs"],
                          device)
    return {"seed": seed, "sound": sound, "control": control, "limits": cell["config"]["limits"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the chip", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed % (1 << 63), args.seconds, torch.device("cuda:0"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
