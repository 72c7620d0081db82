#!/usr/bin/env python3
"""Time kernels of one checkout of this repo on the card, through that
checkout's own chip_smoke.py checks, so that two versions of a kernel are
measured by the same yardstick on the same machine:

    git archive HEAD~1 | tar -x -C _archive/parent    # a gitignored directory
    for t in _archive/parent . . _archive/parent; do
        python3 kernel_ab.py $t shade traverse surface surface_v2
    done

Each run builds the checkout's kernel library (its register/spill report
and static SASS instruction counts are printed), runs check_<kernel> of the
checkout's chip_smoke.py for each named kernel (each raises if its kernel
disagrees with the plain version) and prints one line per kernel:
`AB <checkout> <kernel> <the check's result as JSON>`. Compare two
checkouts only within one machine session, in turns as above.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv: list[str]) -> int:
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    tree = os.path.abspath(argv[1])
    label = os.path.relpath(tree, HERE)
    # the checkout's own package and chip_smoke.py
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from zyg_tpu_torch import ops

    # this checkout's SASS counter, for checkouts whose chip_smoke lacks one
    spec = importlib.util.spec_from_file_location("_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)

    dev = torch.device("cuda", 0)
    chip_smoke.phase_build()
    print(f"SASS {label} {json.dumps(here.sass_counts(ops.build_info['path']))}", flush=True)
    for name in argv[2:]:
        result = getattr(chip_smoke, "check_" + name)(dev)
        print(f"AB {label} {name} {json.dumps(result)}", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
