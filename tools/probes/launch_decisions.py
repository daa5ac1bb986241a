"""Why the serving launcher's chain fuses as it does: ``RUNS`` runs of
``python -m repro_torch.launch.serve --arch <arch>`` as its ``main`` runs it
(full width, random weights from seed 0, the launcher's default policy and
flags), in this process, on the card, from the source tree given as
argv[1]. Prints one JSON line.

For each run: every policy decision whose outcome or reason differs from the
edge's previous one (caller, callee, fuse, reason, sync observations, mean
sync wait in s, the edge's measured sync-wait EWMA, the merge cost then),
each merge (members, healthy, build seconds), and the launcher's record
(merges, instances left, per-token ms). To compare two trees, run them in
one call, in the order A, B, B, A:

    for t in parent change change parent; do python3 tools/probes/launch_decisions.py $t stablelm-1.6b; done
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(sys.argv[1]).resolve()
ARCH = sys.argv[2] if len(sys.argv) > 2 else "stablelm-1.6b"
RUNS = int(sys.argv[3]) if len(sys.argv) > 3 else 2
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import merger as merger_mod  # noqa: E402
from repro_torch.core import policy as policy_mod  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402


def main() -> None:
    build.load()
    decisions, merges = [], []
    decide, do_merge = policy_mod.FusionPolicy.decide, merger_mod.Merger._do_merge

    def logged_decide(self, caller, callee, stats, trust_a, trust_b, signals=None, **kwargs):
        d = decide(self, caller, callee, stats, trust_a, trust_b, signals=signals, **kwargs)
        if self.enabled:
            cm = self.cost_model
            row = [caller.split("/")[-1], callee.split("/")[-1], d.fuse, d.reason, stats.sync_count,
                   stats.mean_wait_s, cm.sync_edge_ewma(caller, callee) if cm is not None else None,
                   self.merge_cost_s]
            last = next((r for r in reversed(decisions) if r[:2] == row[:2]), None)
            if last is None or last[2:4] != row[2:4]:
                decisions.append(row)
        return d

    def logged_merge(self, caller, callee, group, *args, **kwargs):
        do_merge(self, caller, callee, group, *args, **kwargs)
        e = self.merge_log[-1]
        merges.append({"members": sorted(m.split("/")[-1] for m in e.members), "healthy": e.healthy,
                       "build_s": e.build_s})

    policy_mod.FusionPolicy.decide = logged_decide
    merger_mod.Merger._do_merge = logged_merge
    cfg = launcher.resolve_arch(ARCH, False, "cuda")
    runs = []
    for _ in range(RUNS):
        decisions.clear()
        merges.clear()
        t0 = time.perf_counter()
        record, _ = launcher.serve(cfg, device="cuda")
        runs.append({"seconds": time.perf_counter() - t0, "decisions": list(decisions), "merges": list(merges),
                     "record": {k: record[k] for k in ("merges", "instances_left", "per_token_ms_pre",
                                                       "per_token_ms_post")}})
        torch.cuda.empty_cache()
    print(json.dumps({"tree": ROOT.name, "arch": ARCH, "runs": runs}))


if __name__ == "__main__":
    main()
