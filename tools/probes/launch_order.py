"""Which merges the serve launchers take, and in which order, on the host:
the JAX package's ``python -m repro.launch.serve`` at its defaults beside
the port's ``python -m repro_torch.launch.serve`` at ``--min-observations``
1 (its default) and 2 (the reference's), each on the reduced configuration
of every architecture with ``TinyTorchBackend`` / ``TinyJaxBackend``. For
the reference it also prints each edge's first sync wait (ms) and whether
the policy fused it at that first observation. Prints one JSON line an
architecture. Run from the repository root (CPU only, about 3 minutes):

    JAX_PLATFORMS=cpu python3 tools/probes/launch_order.py
"""
import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro.core import policy as jax_policy  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402

ARCHS = ["llama3.2-1b", "stablelm-1.6b", "starcoder2-3b", "granite-34b", "chameleon-34b", "seamless-m4t-medium",
         "mamba2-370m", "qwen3-moe-30b-a3b", "zamba2-7b"]
SMALL = ["--reduced", "--tokens", "5", "--prompt-len", "8", "--max-len", "16"]


def merges(main, argv, sys_argv: bool) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if sys_argv:
            sys.argv = ["serve", *argv]
            main()
        else:
            main(argv)
    return [sorted(m.split("/")[-1] for m in group) for group in json.loads(out.getvalue())["merges"]]


def main() -> None:
    torch.set_num_threads(2)
    first_sight = []
    decide = jax_policy.FusionPolicy.decide

    def logged(self, caller, callee, stats, *args, **kwargs):
        d = decide(self, caller, callee, stats, *args, **kwargs)
        if stats.sync_count == 1:
            first_sight.append([caller.split("/")[-1], callee.split("/")[-1], stats.mean_wait_s * 1e3, d.fuse])
        return d

    jax_policy.FusionPolicy.decide = logged
    for arch in ARCHS:
        first_sight.clear()
        ref = merges(jax_serve.main, ["--arch", arch, *SMALL], True)
        waits = list(first_sight)
        port = {k: merges(port_serve.main, ["--arch", arch, *SMALL, "--device", "cpu", "--min-observations", k], False)
                for k in ("1", "2")}
        print(json.dumps({"arch": arch, "reference": ref, "reference_first_sight": waits, "port_floor_1": port["1"],
                          "port_floor_2": port["2"], "floor_1_same": port["1"] == ref,
                          "floor_2_same": port["2"] == ref}), flush=True)


if __name__ == "__main__":
    main()
