"""cuDNN TF32 off against on in the port's bench, in turns, in one process.

    python tools/bench_tf32.py [bench arguments]
    python tools/bench_tf32.py --data MultiviewC --batch 8

Runs `vfa_tpu_torch.bench.main` four times with the given arguments: cuDNN
TF32 off, on, on, off (the bench's CUDNN_TF32 flipped; matmul TF32 stays
off), each run printing its own JSON line and stderr lines, then one line
per run. The rig comes from the bench's rig cache after the first run.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vfa_tpu_torch import bench  # noqa: E402


def main(argv) -> None:
    rows = []
    for on in (False, True, True, False):
        bench.CUDNN_TF32 = on
        rows.append((on, bench.main(argv)))
    for on, res in rows:
        print(f"cuDNN TF32 {'on ' if on else 'off'}: {res['value']} scenes/s, "
              f"{res['tflops_per_sec']} TFLOP/s, mfu {res.get('mfu')}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
