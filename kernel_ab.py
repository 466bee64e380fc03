#!/usr/bin/env python3
"""Time a kernel of two trees on the same captured inputs.

    python3 kernel_ab.py capture k6 INPUTS.pt
    python3 kernel_ab.py capture k2 INPUTS.pt
    python3 kernel_ab.py measure ROOT INPUTS.pt

``capture k6`` trains ResNet-50 v1 as ``chip_smoke.py`` phase 14 does
(this tree's port) and saves the first counted step's K6 inputs, one
call per stage shape.  ``capture k2`` serves ``chip_smoke.py`` phase 5's
traffic through the 32-layer Llama-3-8B, over bf16 pools and over int8
pools, and saves layer 0's K2 inputs at two chunks of each: the first
at position 256 or later and the last chunk of the longest prompt.
``measure`` imports the ``chip_smoke`` and ``mxtpu_torch`` of the
checkout at ROOT (this tree or another, such as its parent unpacked
with ``git archive``), and prints one JSON line per captured call: that
tree's ``chip_smoke.measure_conv`` (K6) or ``chip_smoke.measure`` (K2)
on the saved inputs (kernel against plain version, kernel, plain and
library times, bounds).  Compare two trees in one session on one card,
in turns: capture, then measure A, B, B, A.  Needs one CUDA card.
"""

import json
import sys

import torch


def _cpu(x):
    return x.cpu() if torch.is_tensor(x) else x


def _cuda(x):
    return x.cuda() if torch.is_tensor(x) else x


def capture(kind):
    """{"kind": kind, "calls": {row name: (args, keywords)}} on the CPU."""
    import chip_smoke

    chip_smoke.card()
    chip_smoke.build()
    if kind == "k6":
        _, captured = chip_smoke.train_resnet50()
        calls = {name: (args, {}) for name, args in captured.items()}
    else:
        model = chip_smoke.llama_3_8b_model()
        calls = {}
        for cache_dtype in (None, "int8"):
            _, caps, _ = chip_smoke.serve_llama_3_8b(model, cache_dtype)
            calls.update({name: cap for name, cap in caps.items()
                          if name.startswith("paged_prefill")})
    return {"kind": kind, "calls": {
        name: ([_cpu(a) for a in args], {k: _cpu(v) for k, v in kw.items()})
        for name, (args, kw) in calls.items()}}


def main(argv):
    if not torch.cuda.is_available():
        print("kernel_ab.py: no CUDA device", file=sys.stderr)
        return 1
    if len(argv) == 3 and argv[0] == "capture" and argv[1] in ("k6", "k2"):
        torch.save(capture(argv[1]), argv[2])
        return 0
    if len(argv) == 3 and argv[0] == "measure":
        sys.path.insert(0, argv[1])
        import chip_smoke

        chip_smoke.card()
        flush = chip_smoke._L2Flush()
        saved = torch.load(argv[2])
        for name, (args, kw) in saved["calls"].items():
            args = [_cuda(a) for a in args]
            if saved["kind"] == "k6":
                res = chip_smoke.measure_conv(args, flush)
                extra = dict(cout=args[1].shape[0])
            else:
                res = chip_smoke.measure(
                    name, args, flush, kw={k: _cuda(v) for k, v in kw.items()})
                extra = dict(start=args[4])
            print(json.dumps(dict(tree=argv[1], kernel=name,
                                  shape=list(args[0].shape), **extra, **res)),
                  flush=True)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
