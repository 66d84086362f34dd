"""Run one benchmark cell once:

    python3 stbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See stbench/README.md."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel caches at fixed paths inside the checkout (the program's own
# libraries go to build/repro_torch/ there)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "stbench",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "stbench",
                                              "triton")
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

from stbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
