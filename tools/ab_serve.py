"""Run chip_smoke.py's serve phase (full-width llama3.2-1b, unfused then
fused, on the card) from the source tree given as argv[1] and print its
per-token p50s, tokens/s and seconds as one JSON line. To compare two
trees, run it for each in one call, alternating the order:

    for t in parent change change parent parent change; do python3 tools/ab_serve.py $t; done
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
out = cs.serve_phase(torch, torch.device("cuda"), get_arch("llama3.2-1b"))
print(json.dumps({"tree": str(sys.argv[1]), "phase_s": time.perf_counter() - t0,
                  **{k: out.get(k) for k in ("p50_token_ms", "tokens_per_s", "decode_steps", "launches")}}))
