"""Time the build of ``csrc/`` two ways on this host: one nvcc for every
source, and ``build.build`` (one nvcc per source, all started together,
then one link).  Each way builds into an empty temporary directory, in
the order one, parallel, parallel, one, repeated ``--rounds`` times.

    python3 -m mistra_tpu_torch.kernels.time_build [--rounds N]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

from . import build


def one_nvcc(out_dir: Path) -> float:
    """Seconds of the single nvcc call that compiles and links every
    source."""
    t0 = time.perf_counter()
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o",
                    str(out_dir / "lib.so"), *map(str, build.sources())],
                   check=True, capture_output=True)
    return time.perf_counter() - t0


def parallel_nvcc(out_dir: Path) -> float:
    """Seconds of ``build.build`` into out_dir."""
    build.BUILD_DIR = out_dir
    build.build()
    return build.build_seconds


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    ways = {"one_nvcc": one_nvcc, "parallel_nvcc": parallel_nvcc}
    times = {name: [] for name in ways}
    for _ in range(args.rounds):
        for name in ("one_nvcc", "parallel_nvcc", "parallel_nvcc",
                     "one_nvcc"):
            with tempfile.TemporaryDirectory(prefix="mistra_build_") as d:
                times[name].append(ways[name](Path(d)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    print(json.dumps({"sources": [s.name for s in build.sources()],
                      "seconds": times}))


if __name__ == "__main__":
    main()
