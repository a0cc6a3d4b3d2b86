"""Run one cell of the benchmark of gswt_renderer_tpu_torch once.

    python3 gswt_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. Prints, as its
last line, one JSON object: correct, attempted, failed, metrics, device
(and with --trace 1 the breakdown), then the compared numbers with their
limits under "compared". Exits non-zero, printing no result, without a card.
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from gswt_bench import harness

    t_process = harness.process_start_s()
    # the port builds into gswt_renderer_tpu_torch/build/ inside the
    # checkout; any library cache torch itself keeps stays there too
    cache = os.path.join(harness.ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.exit(harness.main(sys.argv[1:], t_process=t_process))
