"""Run chip_smoke.py's batched phase (full-width llama3.2-1b, on the card)
from the source tree given as argv[1] and print its requests/s, percentiles
and lane checks as one JSON line. To compare two trees, run it for each in
one call, in the order A, B, B, A:

    for t in parent change change parent; do python3 tools/ab_batched.py $t; done
"""
import json
import sys
import time
from pathlib import Path

root = Path(sys.argv[1]).resolve()
sys.path[:0] = [str(root / "src"), str(root)]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

build.load()
t0 = time.perf_counter()
out = cs.batched_phase(torch, torch.device("cuda"), get_arch("llama3.2-1b"))
keys = ("fused_serial", "fused_batched", "batched_over_serial_requests_per_s", "max_batch_seen", "lane_rel_err",
        "lane_check_bucket_replays", "buckets_captured")
print(json.dumps({"tree": root.name, "phase_s": time.perf_counter() - t0, **{k: out.get(k) for k in keys}}))
