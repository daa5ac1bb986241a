"""What a captured decode step's CUDA-graph memory pool holds.

Serves a few greedy tokens of ``arch`` (full width, random weights from seed
0) through a fused chain on the card, with the caching allocator's history
recorded, then prints the segments of the fused unit's graph pool (the pool
its graphs share; here the decode entry's alone: size, kind, blocks) and,
for each block of 1 MiB or more, the size and the port's source lines of
the allocation that made it. Run from the repository root on the card:

    python3 tools/probes/graph_pool.py zamba2-7b
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import FusionPolicy, TinyTorchBackend  # noqa: E402
from repro_torch.core import function as fn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


def main(arch: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    graphs = []
    capture = fn._capture_graph

    def recorded(warmup, f, d, pool):
        torch.cuda.memory._record_memory_history(max_entries=200000)
        out = capture(warmup, f, d, pool)
        graphs.append(out[1])
        return out

    fn._capture_graph = recorded
    cfg, params, _ = cs.fresh_model(torch, dev, arch)
    platform = TinyTorchBackend(FusionPolicy(min_observations=2, merge_cost_s=0.0))
    try:
        engine = ServingEngine(build_model(cfg), platform, max_len=cs.MAX_LEN, params=params, device=dev)
        prompt = torch.randint(0, cfg.vocab_size, (1, 37), device=dev, dtype=torch.int32)
        engine.generate({"tokens": prompt}, steps=6)
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        pool = tuple(graphs[-1].pool())
        segments = [s for s in snap["segments"] if tuple(s.get("segment_pool_id") or ()) == pool]
        print(cs.device_line())
        print(f"{arch}: the fused unit's graph pool: {sum(s['total_size'] for s in segments)} B in "
              f"{len(segments)} segments")
        traces = {}
        for ev in snap.get("device_traces", [[]])[0]:
            if ev["action"] == "alloc":
                traces[ev["addr"]] = (ev["size"], [f"{fr['filename'].split('/')[-1]}:{fr['line']}:{fr['name']}"
                                                  for fr in ev["frames"] if "repro_torch" in fr["filename"]][:4])
        for s in segments:
            print(s["total_size"], s["segment_type"], [(b["size"], b["state"]) for b in s["blocks"]])
            addr = s["address"]
            for b in s["blocks"]:
                if addr in traces and traces[addr][0] >= 1 << 20:
                    print("   ", traces[addr])
                addr += b["size"]
    finally:
        platform.shutdown()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "zamba2-7b")
