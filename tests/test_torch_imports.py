"""Hygiene of the port: it imports neither jax nor the JAX package, and
its entry points default to the GPU without falling back to the CPU."""

import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "walkai_nos_tpu_torch"


def _port_sources():
    """The package's Python files; the kernel build directory holds
    build outputs, not sources, and is skipped."""
    return sorted(
        p for p in PKG.rglob("*.py")
        if "_kernels_build" not in p.relative_to(PKG).parts
    )


def _port_modules():
    mods = []
    for path in _port_sources():
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax():
    mods = _port_modules()
    assert "walkai_nos_tpu_torch.ops.decode_attention" in mods
    for mod in ("ops.attention", "models.vit", "models.train", "models.trainer",
                "models.checkpoint", "models.data", "models.vit_serving",
                "utils.flops"):
        assert f"walkai_nos_tpu_torch.{mod}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'flax')) "
        "or m == 'walkai_nos_tpu' or m.startswith('walkai_nos_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("clean")


def test_no_source_mentions_the_jax_package_imports():
    for path in _port_sources() + [ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), path
            assert not s.startswith(
                ("import walkai_nos_tpu.", "from walkai_nos_tpu.",
                 "import walkai_nos_tpu ", "from walkai_nos_tpu ")
            ), path


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown")


def test_default_device_is_cuda_and_refuses_without_gpu():
    from walkai_nos_tpu_torch.device import resolve_device
    from walkai_nos_tpu_torch.models.lm import LM_TINY, DecoderLM
    from walkai_nos_tpu_torch.models.data import prefetch_to_device
    from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
    from walkai_nos_tpu_torch.models.train import (
        init_train_state,
        make_infer_step,
        make_train_step,
    )
    from walkai_nos_tpu_torch.models.vit import VIT_TINY, ViTDetector
    from walkai_nos_tpu_torch.models.vit_serving import ViTServer

    _no_gpu()
    assert resolve_device("cpu") == torch.device("cpu")
    cpu_vit = ViTDetector(VIT_TINY, device="cpu")
    for build in (
        lambda: resolve_device(None),
        lambda: DecoderLM(LM_TINY),
        lambda: ContinuousBatcher(LM_TINY, {}, slots=1, cache_len=128),
        lambda: ViTDetector(VIT_TINY),
        lambda: init_train_state(VIT_TINY),
        lambda: make_train_step(VIT_TINY),
        lambda: make_infer_step(VIT_TINY),
        lambda: ViTServer(VIT_TINY, cpu_vit),
        lambda: prefetch_to_device(iter([])),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """`python3 chip_smoke.py` exits non-zero and prints no result line
    without a GPU, and also when run alone, outside the repo."""
    _no_gpu()
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, "chip_smoke.py")):
        if cwd is tmp_path:
            (tmp_path / script).write_text((ROOT / script).read_text())
        out = subprocess.run(
            [sys.executable, script], cwd=cwd, capture_output=True,
            text=True, timeout=120,
        )
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
