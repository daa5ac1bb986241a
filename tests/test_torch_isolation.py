"""The port stands alone: it imports neither JAX nor the ``repro`` package,
calls no library attention kernel, and runs on the card unless asked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import DEFAULT_DEVICE, resolve_device  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    return names


def test_port_imports_no_jax_and_nothing_of_repro():
    assert len(PORT_FILES) > 20
    bad = [
        (str(p.relative_to(ROOT)), name)
        for p in PORT_FILES
        for name in imported_modules(p)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_the_scan_covers_the_launcher_and_every_config():
    scanned = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/launch/serve.py" in scanned
    # the training path
    for name in ("optim/adamw.py", "optim/schedule.py", "data/pipeline.py", "training/train_step.py",
                 "training/loop.py", "launch/train.py", "checkpointing/manager.py", "bridge.py"):
        assert f"src/repro_torch/{name}" in scanned
    for name in ("stablelm_1_6b", "starcoder2_3b", "granite_34b", "chameleon_34b"):
        assert f"src/repro_torch/configs/{name}.py" in scanned


def test_port_calls_no_library_attention_kernel():
    for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        text = p.read_text(encoding="utf-8")
        for word in ("scaled_dot_product_attention", "torch.compile", "cudnn"):
            assert word not in text, f"{p.name} mentions {word}"


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    assert DEFAULT_DEVICE == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.models.model import build_model

    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(reduced_config(get_arch("llama3.2-1b"))).init(0)


def test_chip_smoke_fails_without_the_repository(tmp_path):
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_a_cuda_device():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # hides any card from torch
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA device" in proc.stderr
