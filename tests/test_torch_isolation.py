"""`sos_tpu_torch` stands alone: no JAX, no flax, nothing of `sos_tpu`,
and no silent run on the CPU when a CUDA device was asked for."""

import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sos_tpu_torch

PKG_DIR = Path(sos_tpu_torch.__file__).resolve().parent
REPO = PKG_DIR.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG_DIR)],
                                                        "sos_tpu_torch."))


def test_importing_every_module_loads_no_jax_flax_or_sos_tpu():
    code = (
        "import importlib, json, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'sos_tpu'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(_modules()) >= 12
    assert {"sos_tpu_torch.train.joint", "sos_tpu_torch.cli.train_joint",
            "sos_tpu_torch.cli.import_checkpoint",
            "sos_tpu_torch.parallel.distributed", "sos_tpu_torch.parallel.mesh",
            "sos_tpu_torch.infer.synthetic_eval",
            "sos_tpu_torch.cli.eval_synthetic",
            "sos_tpu_torch.eval.pesq_conformance",
            "sos_tpu_torch.cli.calibrate", "sos_tpu_torch.cli.export_serving",
            "sos_tpu_torch.cli.doctor", "sos_tpu_torch.cli.parity_check",
            "sos_tpu_torch.infer.export", "sos_tpu_torch.runtime.engine",
            "sos_tpu_torch.data.media",
            "sos_tpu_torch.data.preprocess", "sos_tpu_torch.cli.preprocess",
            "sos_tpu_torch.cli.report", "sos_tpu_torch.train.visualize",
            "sos_tpu_torch.__main__"} <= set(_modules())


def test_sources_import_no_jax_or_sos_tpu():
    pattern = re.compile(
        r"^\s*(import\s+(jax|jaxlib|flax|sos_tpu)\b(?!_torch)"
        r"|from\s+(jax|jaxlib|flax|sos_tpu)\b(?!_torch))", re.M)
    offenders = [str(p.relative_to(REPO)) for p in sorted(PKG_DIR.rglob("*.py"))
                 if pattern.search(p.read_text())]
    offenders += ["chip_smoke.py"] * bool(pattern.search((REPO / "chip_smoke.py").read_text()))
    assert offenders == []


def test_pipeline_without_a_card_raises_instead_of_running_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from sos_tpu_torch.config import ExperimentConfig
    from sos_tpu_torch.infer.fused import FusedDenoisePipeline

    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedDenoisePipeline(ExperimentConfig(), {}, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedDenoisePipeline(ExperimentConfig(), {}, {}, device="cuda")


def test_every_sos_tpu_module_has_a_port():
    """The port's file list covers `sos_tpu`'s: no module is unported."""
    def modules(root):
        return {str(p.relative_to(root)) for p in root.rglob("*.py")}
    assert modules(REPO / "sos_tpu") <= modules(PKG_DIR)
