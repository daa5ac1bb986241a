"""The port's serve launcher (``python -m repro_torch.launch.serve``) against
the JAX package's (``python -m repro.launch.serve``): the same JSON keys
(plus ``device``), the same greedy tokens on the same weights and draws, and
no architecture served that the port does not register."""
import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # the suite runs several workers at once: leave them cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.core import FusionPolicy as JaxFusionPolicy  # noqa: E402
from repro.core import TinyJaxBackend  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCHS = ["llama3.2-1b", "stablelm-1.6b", "starcoder2-3b", "granite-34b", "chameleon-34b"]
SMALL = ["--reduced", "--tokens", "5", "--prompt-len", "8", "--max-len", "16"]


def run_json(main, argv, monkeypatch, capsys, **kw) -> dict:
    capsys.readouterr()
    if kw.get("argv_style") == "sys":
        monkeypatch.setattr(sys, "argv", ["serve", *argv])
        main()
    else:
        main(argv)
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_prints_the_reference_keys(arch, monkeypatch, capsys):
    """``--reduced --device cpu``: the reference launcher's keys and one
    more, ``device``; the chain fused to one instance by one healthy merge of
    every member, as the reference's does, through the reference's merges in
    the reference's order (the head's edge first)."""
    ref = run_json(jax_serve.main, ["--arch", arch, *SMALL], monkeypatch, capsys, argv_style="sys")
    got = run_json(serve.main, ["--arch", arch, *SMALL, "--device", "cpu"], monkeypatch, capsys)
    assert set(got) == set(ref) | {"device"}
    assert got["device"] == "cpu" and got["backend"] == "tinytorch" and ref["backend"] == "tinyjax"
    assert got["arch"] == ref["arch"] == arch
    assert got["instances_left"] == ref["instances_left"] == 1
    chain = {f"{arch}/embed", f"{arch}/g0", f"{arch}/g1", f"{arch}/head"}
    assert set(got["merges"][-1]) == set(ref["merges"][-1]) == chain
    assert [set(m) for m in got["merges"]] == [set(m) for m in ref["merges"]]
    assert len(got["generated"]) == len(ref["generated"]) == 5


@pytest.mark.parametrize("arch", ["mamba2-370m", "qwen3-moe-30b-a3b", "zamba2-7b"])
def test_the_launcher_takes_the_reference_merges_at_its_defaults(arch, monkeypatch, capsys):
    """The SSM, MoE and hybrid chains at both launchers' defaults: the same
    healthy merges in the same order, ending in one instance. The
    reference's first hop over each edge compiles its callee (over 100 ms
    for these heads on the host, ``tools/probes/launch_order.py``), which
    promotes the edge under its floor of 2; the port's first run compiles
    nothing, and its floor of 1 takes the same decisions. Under the port's
    old floor of 2 (``--min-observations 2``) the order varied from run to
    run, the head's edge often last."""
    ref = run_json(jax_serve.main, ["--arch", arch, *SMALL], monkeypatch, capsys, argv_style="sys")
    got = run_json(serve.main, ["--arch", arch, *SMALL, "--device", "cpu"], monkeypatch, capsys)
    assert got["instances_left"] == ref["instances_left"] == 1
    assert [set(m) for m in got["merges"]] == [set(m) for m in ref["merges"]]
    assert f"{arch}/head" in got["merges"][0]


def jax_tokens(arch, params, inputs, steps, max_len):
    """The JAX engine's greedy tokens on ``params`` (float32) for ``inputs``."""
    model = jax_build_model(jax_reduced(jax_get_arch(arch)))
    platform = TinyJaxBackend(JaxFusionPolicy(enabled=False))
    try:
        engine = JaxServingEngine(model, platform, max_len=max_len, params=params)
        toks, _ = engine.generate(inputs, steps=steps)
    finally:
        platform.shutdown()
    return np.asarray(toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_generates_the_jax_engine_tokens_in_float32(arch):
    """The launcher's work function on the JAX model's float32 weights
    (bridged) and the launcher's own draws gives the tokens that the JAX
    ``ServingEngine.generate`` gives on the same draws."""
    jcfg = jax_reduced(jax_get_arch(arch))
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32), jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    tcfg = serve.resolve_arch(arch, reduced=True)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), build_model(tcfg).param_defs,
                                dtype=torch.float32, device="cpu")
    record, got = serve.serve(tcfg, batch=2, prompt_len=8, tokens=6, max_len=16, device="cpu", params=tparams)
    inputs = serve.prompt_inputs(tcfg, 2, 8, "cpu", torch.float32)
    jin = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}
    assert got.shape == (2, 6) and record["generated"] == got[0].tolist()[:8]
    np.testing.assert_array_equal(got.numpy(), jax_tokens(arch, jparams, jin, 6, 16))


def test_launcher_draws_the_reference_prompts():
    """The same draws from ``default_rng(0)`` as the reference launcher:
    the token ids exactly, the embeds rounded to bf16 as the reference's."""
    tcfg = serve.resolve_arch("llama3.2-1b", reduced=True)
    toks = serve.prompt_inputs(tcfg, 2, 8, "cpu")["tokens"].numpy()
    rng = np.random.default_rng(0)
    assert np.array_equal(toks, np.asarray(jnp.asarray(rng.integers(0, tcfg.vocab_size, (2, 8)), jnp.int32)))
    vcfg = serve.resolve_arch("chameleon-34b", reduced=True)
    emb = serve.prompt_inputs(vcfg, 2, 8, "cpu")["embeds"]
    rng = np.random.default_rng(0)
    ref = jnp.asarray(rng.standard_normal((2, 8, vcfg.d_model)) * 0.02, jnp.bfloat16)
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(emb.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("arch,error,reason", [
    ("phi3.5-moe-42b-a6.6b", ValueError, "one 80 GB card"),
    ("no-such-model", KeyError, "unknown arch"),
])
def test_an_unregistered_architecture_raises(arch, error, reason):
    with pytest.raises(error, match=reason):
        serve.resolve_arch(arch)
    with pytest.raises(error, match=reason):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_the_enc_dec_architecture_is_served_and_fuses(monkeypatch, capsys):
    """seamless-m4t-medium, once refused, resolves to the JAX package's
    configuration, and the launcher serves the reduced one on the CPU: the
    two-function app (encoder -> decoder) fuses to one unit by one healthy
    merge of both members, as the reference launcher's does, with the
    reference's keys and ``device``.

    Both launchers run at their defaults. A generate makes one prefill, the
    only call that crosses the app's synchronous edge (a decode step invokes
    the decoder itself). The reference's floor is 2, and its first call
    compiles, a wait past the policy's promotion threshold (50 ms) that
    halves the floor to 1; the port's floor is 1. Under the port's old floor
    of 2 (``--min-observations 2``) the edge fused only when the port's
    eager first call reached 50 ms, in some runs only: that run serves the
    same tokens, fused or not."""
    arch = "seamless-m4t-medium"
    assert dataclasses.asdict(serve.resolve_arch(arch)) == dataclasses.asdict(jax_get_arch(arch))
    assert list(serve.NOT_SERVED) == ["phi3.5-moe-42b-a6.6b"]
    argv = ["--arch", arch, *SMALL]
    ref = run_json(jax_serve.main, argv, monkeypatch, capsys, argv_style="sys")
    got = run_json(serve.main, [*argv, "--device", "cpu"], monkeypatch, capsys)
    assert set(got) == set(ref) | {"device"} and got["device"] == "cpu"
    assert got["instances_left"] == ref["instances_left"] == 1
    chain = {f"{arch}/embed", f"{arch}/decoder"}
    assert [set(m) for m in got["merges"]] == [set(m) for m in ref["merges"]] == [chain]
    assert len(got["generated"]) == len(ref["generated"]) == 5
    floor2 = run_json(serve.main, [*argv, "--device", "cpu", "--min-observations", "2"], monkeypatch, capsys)
    assert floor2["generated"] == got["generated"]
    assert [set(m) for m in floor2["merges"]] == [chain] * (2 - floor2["instances_left"])


def test_the_launcher_runs_on_the_card_unless_asked(monkeypatch):
    """No ``--device``: the card, and with no card an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "llama3.2-1b", "--reduced"])


def test_chip_smoke_launch_serve_phase_rehearsal_on_cpu(monkeypatch):
    """chip_smoke.py's launch_serve phase on the CPU: the launcher in a
    process of its own, its JSON parsed and checked (here with ``--device
    cpu`` and reduced models; the card run names no device)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "LAUNCH_RUNS", (
        ("stablelm-1.6b", ("--reduced", "--device", "cpu", "--tokens", "5")),
        ("chameleon-34b", ("--reduced", "--backend", "orchestrated", "--device", "cpu"))))
    out = smoke.launch_serve_phase(torch, torch.device("cpu"))
    assert [r["arch"] for r in out["runs"]] == ["stablelm-1.6b", "chameleon-34b"]
    assert [r["backend"] for r in out["runs"]] == ["tinytorch", "orchestrated"]
    assert all(r["instances_left"] == 1 and r["device"] == "cpu" and r["chain"] == 4 for r in out["runs"])


def test_a_reduced_model_on_the_card_takes_a_head_dim_the_kernels_take():
    """``--reduced`` is the JAX package's reduced configuration; on a CUDA
    device its heads are widened to 64 (the kernels take 64, 112 and 128)."""
    on_host = serve.resolve_arch("chameleon-34b", reduced=True)
    on_card = serve.resolve_arch("chameleon-34b", reduced=True, device="cuda")
    assert on_host.d_head == 16 and on_card.d_head == 64
    assert dataclasses.replace(on_card, d_head=16) == on_host
    assert serve.resolve_arch("chameleon-34b", device="cuda") == serve.resolve_arch("chameleon-34b")
