"""The benchmark's command: one run of one cell on one card.

    python3 -m sdrbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It prints one JSON object as the last line
of standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit), and the same numbers as the last lines
of standard error.  Without a CUDA card, or with fewer cards than the
cell asks for, it prints no result and exits with 2; if JAX or the JAX
package were loaded once the window has closed, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed place inside the checkout; the
# program's own CUDA libraries go to build/sdrtpu_torch/ beside it
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "cuda_cache"}
for var, sub in CACHES.items():
    os.environ[var] = str(ROOT / "build" / "sdrbench" / sub)

FORBIDDEN = {"jax", "jaxlib", "flax", "sdrtpu"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run must not hold,
    compared whole (``sdrtpu_torch`` is not ``sdrtpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from sdrbench import harness

    cell = harness.load_cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"sdrbench: {args.workload} needs {chips} CUDA card(s); "
            f"torch sees {torch.cuda.device_count()}: no result")
        return 2
    torch.cuda.set_device(0)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START, log=log)
    found = forbidden_modules()
    if found:
        log(f"sdrbench: the run loaded {found}: no result")
        return 3
    try:
        from sdrbench.frozen.smi import card_line

        log(f"card: {card_line()}")
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        log(f"card: nvidia-smi unreadable ({exc})")
    log(f"correct: {out['correct']}")
    for name, d in out["checks"].items():
        log(f"{name} {d['value']!r} limit {d['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
