#!/usr/bin/env python3
"""Time K6, the conv backward kernel, of two trees on the same inputs.

    python3 conv_bwd_ab.py capture INPUTS.pt
    python3 conv_bwd_ab.py measure ROOT INPUTS.pt

``capture`` trains ResNet-50 v1 as ``chip_smoke.py`` phase 14 does (this
tree's port) and saves the first counted step's K6 inputs, one call per
stage shape, to INPUTS.pt.  ``measure`` imports the ``chip_smoke`` and
``mxtpu_torch`` of the checkout at ROOT (this tree or another, such as
its parent unpacked with ``git archive``), and prints one JSON line per
stage shape: that tree's ``chip_smoke.measure_conv`` on the saved
inputs (kernel against plain version, kernel, plain and cuDNN times,
bounds).  Compare two trees in one session on one card, in turns:
capture, then measure A, B, B, A.  Needs one CUDA card.
"""

import json
import sys

import torch


def main(argv):
    if not torch.cuda.is_available():
        print("conv_bwd_ab.py: no CUDA device", file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "capture":
        import chip_smoke

        chip_smoke.card()
        chip_smoke.build()
        _, captured = chip_smoke.train_resnet50()
        torch.save({name: [a.cpu() for a in args]
                    for name, args in captured.items()}, argv[1])
        return 0
    if len(argv) == 3 and argv[0] == "measure":
        sys.path.insert(0, argv[1])
        import chip_smoke

        chip_smoke.card()
        flush = chip_smoke._L2Flush()
        for name, args in torch.load(argv[2]).items():
            res = chip_smoke.measure_conv([a.cuda() for a in args], flush)
            print(json.dumps(dict(tree=argv[1], kernel=name,
                                  shape=list(args[0].shape),
                                  cout=args[1].shape[0], **res)),
                  flush=True)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
