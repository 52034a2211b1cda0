"""The control of a cell's comparison, on the card at the cell's own size.

    python3 pubsub_bench/control.py --workload <cell> --seed <n> \\
        --seconds <window> --trace 0

A run of the cell in which the control takes the program's place in the
comparison: the plain reference computed one precision below the
configuration's float32, in bfloat16 (``reference/gossipsub.py``
``Network(float_dtype=torch.bfloat16)``).  The program still runs the
window, but what is judged is the control's output.  Its result line must read
``correct: false``: the numbers it prints are the upper readings the
limits are set below.  The benchmark's own runs never run this.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run  # noqa: E402  (sets the caches and the import path first)

if __name__ == "__main__":
    sys.exit(run.main(control=True))
