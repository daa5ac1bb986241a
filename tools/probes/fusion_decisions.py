"""Why a chain fuses as it does: every fusion-policy decision and merge of
``chip_smoke.py``'s serve phase for ``arch`` (full width, random weights from
seed 0), on the card.

With ``--signals`` each decision gets the request scheduler's live signals
(``platform.scheduler.signals_for``), as the JAX package's Merger passes them
through its platform's ``scheduler_signals``; without, as the port's Merger
decides. Prints the fusing platform's
decisions (caller, callee, fuse, reason, sync observations, mean sync wait
in s, the merge cost then; each distinct outcome of an edge once), each
merge (members, healthy, build seconds), and whether the serve phase's
checks passed. Run from the repository root:

    python3 tools/probes/fusion_decisions.py qwen3-moe-30b-a3b --signals
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


def main(arch: str, with_signals: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    decisions, merges, platform_of = [], [], {}
    decide, init, do_merge = policy_mod.FusionPolicy.decide, merger_mod.Merger.__init__, merger_mod.Merger._do_merge

    def merger_init(self, platform, policy, **kw):
        init(self, platform, policy, **kw)
        platform_of[id(policy)] = platform

    def logged_decide(self, caller, callee, stats, trust_a, trust_b, signals=None):
        if with_signals and signals is None:
            platform = platform_of[id(self)]
            signals = lambda: platform.scheduler.signals_for((caller, callee))  # noqa: E731
        d = decide(self, caller, callee, stats, trust_a, trust_b, signals=signals)
        if self.enabled:
            decisions.append((caller, callee, d.fuse, d.reason, stats.sync_count, stats.mean_wait_s,
                              self.merge_cost_s))
        return d

    def logged_merge(self, caller, callee, group):
        do_merge(self, caller, callee, group)
        e = self.merge_log[-1]
        merges.append({"members": e.members, "healthy": e.healthy, "reason": e.reason, "build_s": e.build_s})

    merger_mod.Merger.__init__ = merger_init
    policy_mod.FusionPolicy.decide = logged_decide
    merger_mod.Merger._do_merge = logged_merge
    cfg, params, _ = cs.fresh_model(torch, dev, arch)
    print(cs.device_line())
    try:
        cs.serve_phase(torch, dev, cfg, params=params)
        print(f"{arch}: the serve phase passed (signals: {with_signals})")
    except cs.SmokeFailure as exc:
        print(f"{arch}: the serve phase failed (signals: {with_signals}): {str(exc)[:200]}")
    seen = set()
    for d in decisions:
        key = (d[0], d[1], d[2], d[3].split(":")[0])
        if key not in seen:
            seen.add(key)
            print(d)
    for m in merges:
        print(json.dumps(m))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "qwen3-moe-30b-a3b", "--signals" in sys.argv)
