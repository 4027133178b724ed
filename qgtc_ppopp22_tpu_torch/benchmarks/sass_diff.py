"""Compare the machine code (SASS) of two builds of the kernel library,
function by function: ``cuobjdump -sass`` of each ``libqgtc_kernels.so``,
instruction offsets and address comments stripped. Prints how many
functions both builds hold and are identical, which of those differ, and
which only one build holds (a kernel added or removed). An edit that
should leave a kernel alone leaves its SASS identical; timings of
identical code still move a few percent between runs. Needs the CUDA
toolkit's ``cuobjdump``.

Usage::

    python -m qgtc_ppopp22_tpu_torch.benchmarks.sass_diff OLD.so NEW.so [--expect-only PATTERN ...]

Exits 1 if a function both hold differs, or if a function only one holds
matches none of the ``--expect-only`` patterns (substrings of the mangled
name).
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys


def functions(lib: str) -> dict:
    """{mangled name: SASS text} of every kernel in the library."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    funcs, name, body = {}, None, []
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m or line.startswith("Fatbin "):  # a function, or the next object file's header
            if name:
                funcs[name] = "\n".join(body)
            # an anonymous namespace's name carries a hash of its file's path
            name, body = (re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", m[1]) if m else None), []
        elif name:
            line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()  # instruction offsets
            if line:  # blank lines are layout (one follows an object file's last function)
                body.append(line)
    if name:
        funcs[name] = "\n".join(body)
    return funcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--expect-only", nargs="*", default=[],
                    help="substrings of the names a build may hold alone")
    args = ap.parse_args(argv)
    old, new = functions(args.old), functions(args.new)
    both = sorted(set(old) & set(new))
    differ = [n for n in both if old[n] != new[n]]
    alone = {"old": sorted(set(old) - set(new)), "new": sorted(set(new) - set(old))}
    print(f"sass_diff: {len(both)} functions in both builds, {len(both) - len(differ)} identical, "
          f"{len(differ)} differ; {len(alone['old'])} only in {args.old}, {len(alone['new'])} only in {args.new}")
    for n in differ:
        print(f"  differs: {n}")
    bad = list(differ)
    for side, names in alone.items():
        for n in names:
            ok = any(p in n for p in args.expect_only)
            print(f"  only in {side}{'' if ok else ' (not expected)'}: {n}")
            bad += [] if ok else [n]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
