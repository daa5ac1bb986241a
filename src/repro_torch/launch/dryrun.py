"""Dry run: every (architecture x input shape x mesh) cell traced on meta
tensors, its FLOPs, HBM bytes, collectives and peak memory counted per
device, and its roofline bound worked out from the H100's datasheet peaks.

The counterpart of the JAX package's ``repro/launch/dryrun.py``. On one
H100 (``--mesh h100x1``, the default), for each cell this driver:
  1. builds the weights, optimizer state, inputs and KV caches as meta
     tensors (``param_structs``: zero allocation, so a 42B-parameter train
     state stays symbolic), as the reference builds ShapeDtypeStructs;
  2. runs the cell's program once on them under ``launch/cost_analysis.py``
     — ``train_step`` on the train state, handed over as a donated state
     runs (``donate.donating()``), ``prefill_fn``, or ``decode_fn`` on the
     donated caches — where every kernel takes the card's branch without a
     launch, in place of ``.lower()`` and ``.compile()``;
  3. chooses the batch of one step: the largest that divides the shape's
     global batch and fits the card, from the peaks at the two smallest
     batches taken as affine in the batch, checked with one more run;
  4. appends one JSON line to the results file.

With ``--execute`` it also runs the cell at that batch on the card, with
random weights — a step under the cost analysis, then a bare timed step —
and adds what the card measured (``measured``).

On a production mesh (``--mesh pod16x16`` or ``pod2x16x16``, the
reference's (16, 16) and (2, 16, 16)) it runs rank 0's program on meta
tensors in a fake process group of 512 ranks (``launch/mesh.py``): the
weights, optimizer state, inputs and caches are meta ``DTensor``s with the
strict placements of the rules the reference's ``run_cell`` picks, the
program is the model built with those rules (``models/sharded.py``), at the
shape's whole global batch, and the record carries the reference's
per-device fields, its collectives counted by kind with ring-model bytes.
The SSM, hybrid and enc-dec families are recorded ``skipped`` there.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
  python -m repro_torch.launch.dryrun --all   # every cell, a subprocess each
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --execute   # on the card
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k --mesh pod16x16
  python -m repro_torch.launch.dryrun --all --both-meshes   # every cell on both production meshes
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HW = {  # NVIDIA H100 SXM 80GB datasheet: dense bf16 tensor-core rate, HBM3 rate and size
    "name": "H100 SXM 80GB HBM3 (datasheet)",
    "peak_flops_bf16": 989e12,
    "hbm_bw": 3.35e12,
    "hbm_bytes": 85.0e9,
    # NVLink 4: 18 links of 25 GB/s each way, 450 GB/s out of one GPU
    "nvlink_bw": 450e9,
}
# The mesh roofline's collective_s is a device's ring-model collective
# bytes over one GPU's NVLink rate: it takes every collective to stay inside
# one NVLink domain. The production meshes (256 and 512 GPUs) cross nodes,
# whose InfiniBand links (400 Gb/s per GPU, 50 GB/s) are 9x slower; the
# term leaves that crossing out, as the reference's ICI term leaves out DCN.
# held back from the card's memory for the CUDA context, cuBLAS's workspaces
# and the caching allocator's rounding
RESERVE_BYTES = 2 * 2**30
MESH = "h100x1"
MESH_NAMES = ("h100x1", "pod16x16", "pod2x16x16")
FAKE_WORLD = 512  # one fake group holds both production meshes (their first ranks)


def count_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts from the symbolic defs."""
    from repro_torch.models.model import build_model
    from repro_torch.models.params import param_count

    model = build_model(cfg)
    total = param_count(model.param_defs)
    active = total
    if cfg.num_experts:
        # replace per-layer expert params with top-k worth of experts
        expert_per_layer = 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_experts
        active_expert = 3 * cfg.d_model * cfg.moe_d_ff * cfg.num_experts_per_tok
        active = total - cfg.num_layers * (expert_per_layer - active_expert)
    return total, active


def model_flops(cfg, shape) -> float:
    """6*N*D (train) / 2*N*D (inference) with N = active params."""
    _, active = count_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train" else (shape.seq_len if shape.kind == "prefill" else 1))
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * active * tokens


def card_bytes() -> int:
    """The card's memory: the device's own total on a CUDA machine, else the
    datasheet's."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return int(HW["hbm_bytes"])


def card_name() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


class Cell:
    """One (architecture, shape) cell's program and its arguments at a batch
    of one step, on meta tensors or materialized on a device."""

    def __init__(self, arch: str, shape_name: str):
        from repro_torch.configs import get_arch, get_shape
        from repro_torch.models.model import build_model

        self.cfg = get_arch(arch)
        self.shape = get_shape(shape_name)
        self.model = build_model(self.cfg)
        self.micro = max(1, self.cfg.microbatches) if self.shape.kind == "train" else 1

    def batches(self) -> list[int]:
        """The batches of one step: divisors of the global batch, multiples
        of the microbatch count (a step splits its batch into them)."""
        g = self.shape.global_batch
        return [b for b in range(self.micro, g + 1, self.micro) if g % b == 0]

    def shape_at(self, batch: int):
        import dataclasses

        return dataclasses.replace(self.shape, global_batch=batch)

    def program(self):
        from repro_torch.optim import AdamWConfig, cosine_schedule
        from repro_torch.training.train_step import make_train_step

        kind = self.shape.kind
        if kind == "train":
            return make_train_step(self.model, AdamWConfig(), cosine_schedule(3e-4, 100, 10000))
        return self.model.prefill_fn if kind == "prefill" else self.model.decode_fn

    def meta_args(self, batch: int) -> tuple:
        from repro_torch.models.params import param_structs
        from repro_torch.training.train_step import make_train_state_defs

        sh = self.shape_at(batch)
        inputs = param_structs(self.model.input_defs(sh))
        if self.shape.kind == "train":
            return param_structs(make_train_state_defs(self.model)), inputs
        params = param_structs(self.model.param_defs)
        if self.shape.kind == "prefill":
            return params, inputs
        return params, inputs, param_structs(self.model.cache_defs(sh))

    def device_args(self, batch: int, device, seed: int = 0) -> tuple:
        from repro_torch.models.params import init_params
        from repro_torch.training.train_step import init_train_state

        sh = self.shape_at(batch)
        inputs = self.model.make_inputs(sh, seed, device=device)
        if self.shape.kind == "train":
            return init_train_state(self.model, seed, device=device), inputs
        params = self.model.init(seed, device=device)
        if self.shape.kind == "prefill":
            return params, inputs
        return params, inputs, init_params(self.model.cache_defs(sh), seed, device=device)

    def call(self, args: tuple) -> None:
        """The program once on ``args``: train and decode hand their state
        and caches over (donated); prefill and decode run without
        autograd."""
        import torch

        from repro_torch import donate

        fn = self.program()
        with torch.set_grad_enabled(self.shape.kind == "train"), donate.donating(self.shape.kind != "prefill"):
            fn(*args)

    def run(self, args: tuple):
        """:meth:`call` under a cost analysis: its summary."""
        from repro_torch.launch.cost_analysis import CostAnalysis

        mode = CostAnalysis(args)
        with mode:
            self.call(args)
        return mode.summary()

    def memory(self, batch: int) -> dict:
        from repro_torch.models.params import param_bytes
        from repro_torch.optim import adamw_state_defs

        sh = self.shape_at(batch)
        out = {"param_bytes": param_bytes(self.model.param_defs),
               "opt_state_bytes": param_bytes(adamw_state_defs(self.model.param_defs)) if sh.kind == "train" else 0,
               "cache_bytes": param_bytes(self.model.cache_defs(sh)) if sh.kind == "decode" else 0,
               "input_bytes": param_bytes(self.model.input_defs(sh))}
        return out


def choose_batch(cell: Cell, limit: int) -> tuple[int, object, bool, float]:
    """(batch, its summary, whether it fits, seconds of meta runs): the
    largest batch of ``cell.batches()`` whose peak plus RESERVE_BYTES is at
    most ``limit``. The peaks at the two smallest batches give an affine
    peak(batch); the chosen batch is run to check it (and the next smaller
    one tried while it does not fit)."""
    cands = cell.batches()
    runs: dict[int, object] = {}
    t0 = time.perf_counter()

    def run(b):
        if b not in runs:
            runs[b] = cell.run(cell.meta_args(b))
        return runs[b]

    fits = lambda s: s.peak_bytes + RESERVE_BYTES <= limit  # noqa: E731
    first = run(cands[0])
    if len(cands) == 1 or not fits(first):
        return cands[0], first, fits(first), time.perf_counter() - t0
    second = run(cands[1])
    slope = (second.peak_bytes - first.peak_bytes) / (cands[1] - cands[0])
    guess = [b for b in cands if first.peak_bytes + slope * (b - cands[0]) + RESERVE_BYTES <= limit]
    i = cands.index(guess[-1] if guess else cands[0])
    while i > 0 and not fits(run(cands[i])):
        i -= 1
    return cands[i], run(cands[i]), fits(run(cands[i])), time.perf_counter() - t0


def run_cell(arch: str, shape_name: str, out_path: str | None = None, execute: bool = False,
             device: str | None = None, mesh: str = MESH) -> dict:
    if mesh != MESH:
        return run_mesh_cell(arch, shape_name, mesh, out_path)
    from repro_torch.configs import get_arch, get_shape, shape_skip_reason

    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    record: dict = {"arch": arch, "shape": shape_name, "mesh": MESH, "kind": shape.kind}
    skip = shape_skip_reason(cfg, shape_name)
    if skip:
        record.update(status="skipped", reason=skip)
        _append(out_path, record)
        return record

    cell = Cell(arch, shape_name)
    limit = card_bytes()
    batch, s, fits, trace_s = choose_batch(cell, limit)
    steps = shape.global_batch // batch
    flops, nbytes = s.flops * steps, s.bytes * steps
    mf = model_flops(cfg, shape)
    total_params, active_params = count_params(cfg)
    compute_s = flops / HW["peak_flops_bf16"]
    memory_s = nbytes / HW["hbm_bw"]
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": 0.0}
    dominant = max(terms, key=terms.get)
    mem = cell.memory(batch)
    mem.update(peak_bytes=s.peak_bytes, workspace_bytes=s.workspace_bytes)
    record.update(
        status="ok",
        n_chips=1,
        hw=HW["name"],
        trace_s=round(trace_s, 2),
        batch_per_step=batch,
        microbatches=cell.micro,
        steps=steps,
        flops_per_device=flops,
        bytes_per_device=nbytes,
        flops_per_step=s.flops,
        bytes_per_step=s.bytes,
        kernel_flops_per_step=s.kernel_flops,
        kernel_calls_per_step=s.kernel_calls,
        loop_trips=s.loop_trips,
        top_traffic=s.top_traffic[:8],
        memory=mem,
        hbm_per_device_gb=round(s.peak_bytes / 2**30, 3),
        card_bytes=limit,
        reserve_bytes=RESERVE_BYTES,
        fits_card=fits,
        params_total=total_params,
        params_active=active_params,
        model_flops_global=mf,
        model_flops_per_device=mf,
        useful_flops_ratio=mf / flops if flops else 0.0,
        roofline={
            **{k: round(v, 6) for k, v in terms.items()},
            "dominant": dominant,
            "bound_s": round(max(terms.values()), 6),
            "step_bound_s": max(s.flops / HW["peak_flops_bf16"], s.bytes / HW["hbm_bw"]),
        },
    )
    if execute:
        record["measured"] = execute_cell(cell, batch, s, device) if fits else {
            "skipped": "fits_card is false"}
    _append(out_path, record)
    return record


def mesh_rules(cfg, shape, mesh):
    """The rules the reference's ``run_cell`` picks for a cell's kind."""
    from repro_torch.sharding.specs import decode_rules, infer_rules, train_rules

    if shape.kind == "decode":
        return decode_rules(mesh, kv_heads=cfg.num_kv_heads or None, batch=shape.global_batch)
    if shape.kind == "prefill":
        return infer_rules(mesh, kv_heads=cfg.num_kv_heads or None)
    return train_rules(mesh)


def _local_bytes(t) -> int:
    from repro_torch import tree
    from repro_torch.launch.cost_analysis import _local

    return sum(_local(x).numel() * x.dtype.itemsize for x in tree.leaves(t))


def run_mesh_cell(arch: str, shape_name: str, mesh_name: str, out_path: str | None = None) -> dict:
    """One cell on a production mesh, as rank 0 of a fake group sees it (see
    the module docstring): the reference's per-device record."""
    from repro_torch.configs import get_arch, get_shape, shape_skip_reason
    from repro_torch.launch import mesh as meshes
    from repro_torch.models.model import MESH_FAMILIES

    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind}
    skip = shape_skip_reason(cfg, shape_name)
    if skip is None and cfg.family not in MESH_FAMILIES:
        skip = f"the {cfg.family} family on a mesh is the next slice (ROADMAP Queue 1 item 16)"
    if skip:
        record.update(status="skipped", reason=skip)
        _append(out_path, record)
        return record

    import torch

    from repro_torch import donate
    from repro_torch.launch.cost_analysis import CostAnalysis
    from repro_torch.models.model import build_model
    from repro_torch.models.params import param_structs
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.training.train_step import make_train_state_defs, make_train_step

    t0 = time.perf_counter()
    meshes.init_fake_world(FAKE_WORLD)
    mesh = meshes.make_production_mesh(multi_pod=meshes.MESHES[mesh_name])
    n_chips = mesh.size()
    rules = mesh_rules(cfg, shape, mesh)
    model = build_model(cfg, rules)
    inputs = param_structs(model.input_defs(shape), mesh, rules)
    params = param_structs(model.param_defs, mesh, rules)
    if shape.kind == "train":
        args = (param_structs(make_train_state_defs(model), mesh, rules), inputs)
        fn = make_train_step(model, AdamWConfig(), cosine_schedule(3e-4, 100, 10000))
    elif shape.kind == "prefill":
        args, fn = (params, inputs), model.prefill_fn
    else:
        args, fn = (params, inputs, param_structs(model.cache_defs(shape), mesh, rules)), model.decode_fn
    mode = CostAnalysis(args)
    with mode, torch.set_grad_enabled(shape.kind == "train"), donate.donating(shape.kind != "prefill"):
        fn(*args)
    s = mode.summary()
    trace_s = time.perf_counter() - t0

    mf = model_flops(cfg, shape)
    total_params, active_params = count_params(cfg)
    terms = {"compute_s": s.flops / HW["peak_flops_bf16"], "memory_s": s.bytes / HW["hbm_bw"],
             "collective_s": s.collective_bytes / HW["nvlink_bw"]}
    dominant = max(terms, key=terms.get)
    record.update(
        status="ok",
        n_chips=n_chips,
        hw=HW["name"],
        trace_s=round(trace_s, 2),
        flops_per_device=s.flops,
        bytes_per_device=s.bytes,
        kernel_flops_per_device=s.kernel_flops,
        kernel_calls_per_device=s.kernel_calls,
        collectives={"total_bytes": s.collective_bytes, **s.collective_detail},
        top_collectives=s.top_collectives[:8],
        loop_trips=s.loop_trips,
        top_traffic=s.top_traffic[:8],
        memory={"argument_bytes": s.input_bytes, "peak_bytes": s.peak_bytes,
                "workspace_bytes": s.workspace_bytes, "input_bytes": _local_bytes(inputs)},
        hbm_per_device_gb=round(s.peak_bytes / 2**30, 3),
        fits_card=s.peak_bytes + RESERVE_BYTES <= HW["hbm_bytes"],
        params_bytes_per_device=_local_bytes(params),
        params_total=total_params,
        params_active=active_params,
        model_flops_global=mf,
        model_flops_per_device=mf / n_chips,
        useful_flops_ratio=(mf / n_chips) / s.flops if s.flops else 0.0,
        roofline={
            **{k: round(v, 6) for k, v in terms.items()},
            "dominant": dominant,
            "bound_s": round(max(terms.values()), 6),
            "collective_rate": "nvlink_bw",
        },
    )
    _append(out_path, record)
    return record


def execute_cell(cell: Cell, batch: int, predicted, device: str | None = None, seed: int = 0) -> dict:
    """Two steps of ``cell`` at ``batch`` on the card (random weights from
    ``seed``): the first under the cost analysis (its loops run whole: the
    card's own counts), the second bare (the analysis's host work per op
    would slow a host-bound step), timed with CUDA events, with the kernels
    it launched (and any plain version it ran, which the card's path must
    not) and the allocator's peak since a reset less what was allocated
    before the cell's weights, state, caches and inputs (which count, as in
    the prediction)."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"--execute runs on the card; got device {dev}")
    build.load()  # built before the step, not inside its time
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    args = cell.device_args(batch, dev, seed)
    on_card = cell.run(args)
    torch.cuda.synchronize(dev)
    kops.reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    cell.call(args)
    end.record()
    end.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    counts = kops.counts()
    launches = {k: counts[k] for k in build.KERNELS if counts[k]}
    plain = {k: counts[k] for k in ref.CALLS if counts[k]}
    del args
    torch.cuda.empty_cache()
    return {
        "card": card_name(),
        "step_ms": start.elapsed_time(end),
        "peak_bytes": peak,
        "predicted_peak_bytes": predicted.peak_bytes,
        "peak_ratio": predicted.peak_bytes / peak,
        "flops": on_card.flops,
        "bytes": on_card.bytes,
        "kernel_calls": on_card.kernel_calls,
        "launches": launches,
        "plain_calls": plain,
    }


def _append(out_path: str | None, record: dict) -> None:
    if out_path:
        with open(out_path, "a") as f:
            f.write(json.dumps(record) + "\n")


def all_cells():
    from repro_torch.configs import ARCHS, SHAPES

    for arch in ARCHS:
        for shape_name in SHAPES:
            yield arch, shape_name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--execute", action="store_true", help="also run one step of the cell on the card")
    ap.add_argument("--device", default=None, help="the device of --execute (default cuda; never falls back)")
    ap.add_argument("--mesh", default=MESH, choices=MESH_NAMES,
                    help="one card (default) or a production mesh, reckoned on meta tensors in a fake group")
    ap.add_argument("--both-meshes", action="store_true", help="both production meshes (pod16x16, pod2x16x16)")
    args = ap.parse_args(argv)
    if args.execute and args.mesh != MESH:
        ap.error("--execute runs on one card (--mesh h100x1)")
    meshes = ["pod16x16", "pod2x16x16"] if args.both_meshes else [args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if not args.all:
        for mesh in meshes:
            record = run_cell(args.arch, args.shape, args.out, args.execute, args.device, mesh)
            print(json.dumps(record, indent=2))
        return

    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except (json.JSONDecodeError, KeyError):
                    continue

    def one(cell):
        arch, shape_name, mesh = cell
        if (arch, shape_name, mesh) in done:
            print(f"[skip-done] {arch} {shape_name} {mesh}", flush=True)
            return
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape_name,
               "--out", args.out, "--mesh", mesh]
        if args.execute:
            cmd.append("--execute")
        if args.device:
            cmd += ["--device", args.device]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, timeout=args.timeout, capture_output=True, text=True)
            if proc.returncode != 0:
                err = (proc.stderr or "").strip().splitlines()
                msg = err[-1] if err else f"exit {proc.returncode}"
                _append(args.out, {"arch": arch, "shape": shape_name, "mesh": mesh, "status": "error",
                                   "reason": msg[-500:]})
                print(f"[cell] {arch} {shape_name}: ERROR {msg[-200:]}", flush=True)
                return
        except subprocess.TimeoutExpired:
            _append(args.out, {"arch": arch, "shape": shape_name, "mesh": mesh, "status": "timeout"})
            print(f"[cell] {arch} {shape_name}: TIMEOUT", flush=True)
            return
        print(f"[cell] {arch} {shape_name} done in {time.perf_counter() - t0:.0f}s", flush=True)

    # each cell a process of its own, half the host's cores at once: meta
    # tensors hold no memory, and a GELU model's prefill_32k traces for minutes
    with ThreadPoolExecutor(max(1, (os.cpu_count() or 2) // 2)) as pool:
        list(pool.map(one, [(a, sh, m) for a, sh in all_cells() for m in meshes]))


if __name__ == "__main__":
    main()
