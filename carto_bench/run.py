#!/usr/bin/env python3
"""Run one benchmark cell once, on the card, and print its result.

    python3 carto_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the repository root. The last line of standard output is the
result as one JSON object; the numbers compared with the reference go to
standard error, each beside its limit.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from carto_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
