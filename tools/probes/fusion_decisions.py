"""Why a chain fuses as it does: every fusion-policy decision and merge of
``chip_smoke.py``'s serve phase for ``arch`` (full width, random weights from
seed 0), on the card, with the fusing platform's policy at the reference's
default promotion (``FusionPolicy(min_observations=2, merge_cost_s=0.0)``,
``promote_wait_s`` 50 ms) instead of chip_smoke's ``SERVE_POLICY``.

The Merger passes the scheduler's signals and the policy reads the
platform's measured costs (``EdgeCostModel``), as in the reference. Prints
the fusing platform's decisions (caller, callee, fuse, reason, sync
observations, mean sync wait in s, the edge's measured sync-wait EWMA, the
measured merge-stall EWMA, the merge cost then; each distinct outcome of an
edge once), each merge (members, healthy, build seconds), the live
instances the fusing platform ends with, and whether the serve phase's
checks passed. Run from the repository root:

    python3 tools/probes/fusion_decisions.py qwen3-moe-30b-a3b
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import merger as merger_mod  # noqa: E402
from repro_torch.core import policy as policy_mod  # noqa: E402


def main(arch: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    decisions, merges, live = [], [], []
    decide, do_merge = policy_mod.FusionPolicy.decide, merger_mod.Merger._do_merge

    def logged_decide(self, caller, callee, stats, trust_a, trust_b, signals=None):
        d = decide(self, caller, callee, stats, trust_a, trust_b, signals=signals)
        if self.enabled:
            cm = self.cost_model
            decisions.append((caller, callee, d.fuse, d.reason, stats.sync_count, stats.mean_wait_s,
                              cm.sync_edge_ewma(caller, callee), cm.merge_stall_ewma(), self.merge_cost_s))
        return d

    def logged_merge(self, caller, callee, group):
        do_merge(self, caller, callee, group)
        e = self.merge_log[-1]
        merges.append({"members": e.members, "healthy": e.healthy, "reason": e.reason, "build_s": e.build_s})
        if self.policy.enabled:
            live.append(len(self.platform.registry.live_instances()))

    policy_mod.FusionPolicy.decide = logged_decide
    merger_mod.Merger._do_merge = logged_merge
    cs.SERVE_POLICY = {"min_observations": 2, "merge_cost_s": 0.0}
    cfg, params, _ = cs.fresh_model(torch, dev, arch)
    print(cs.device_line())
    try:
        cs.serve_phase(torch, dev, cfg, params=params)
        print(f"{arch}: the serve phase passed")
    except cs.SmokeFailure as exc:
        print(f"{arch}: the serve phase failed: {str(exc)[:200]}")
    seen = set()
    for d in decisions:
        key = (d[0], d[1], d[2], d[3].split(":")[0])
        if key not in seen:
            seen.add(key)
            print(d)
    for m in merges:
        print(json.dumps(m))
    print(json.dumps({"live_instances_after_merges": live[-1] if live else None}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "qwen3-moe-30b-a3b")
