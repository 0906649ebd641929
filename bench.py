"""Benchmark: prints one JSON line, end-to-end decode plus per-kind
device decode and encode (alacnet_tpu/bench_lib.run_full_benchmark).

Runs only on a GPU: exits non-zero, with no result, when JAX finds
none.  The record names the device (platform, kind, count) and the
card's name and power limit.

    python bench.py
"""

import json


def main() -> None:
    from alacnet_tpu.bench_lib import (
        gpu_name_and_power_limit, require_gpu, run_full_benchmark,
    )
    from alacnet_tpu.utils.compile_cache import enable_compile_cache

    require_gpu()
    enable_compile_cache()
    result = run_full_benchmark(repeats=3)
    result["card"] = gpu_name_and_power_limit()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
