"""The port stands alone: importing every module of `repro_torch` loads no
JAX and nothing of the JAX package, and `chip_smoke.py` imports neither.
Importing starts no process group either (the dry run's fake group lives
inside `run_cell`)."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")  # the port's tests need PyTorch
import repro_torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_imports_no_jax_and_no_repro():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert {"repro_torch.runtime.server", "repro_torch.models.model",
            "repro_torch.models.transformer", "repro_torch.models.attention",
            "repro_torch.models.ssm", "repro_torch.kernels.ops",
            "repro_torch.kernels.ref", "repro_torch.models.moe",
            "repro_torch.models.expert_tiering",
            "repro_torch.configs.olmoe_1b_7b",
            "repro_torch.configs.mixtral_8x7b", "repro_torch.configs.glm4_9b",
            "repro_torch.configs.granite_20b",
            "repro_torch.configs.granite_34b", "repro_torch.core.engine",
            "repro_torch.core.frontend", "repro_torch.core.page_util",
            "repro_torch.core.simheap", "repro_torch.core.graphs",
            "repro_torch.data.ycsb", "repro_torch.convert",
            "repro_torch.device", "repro_torch.tree",
            "repro_torch.optim.adamw", "repro_torch.data.lm",
            "repro_torch.checkpoint.ckpt", "repro_torch.runtime.trainer",
            "repro_torch.launch.train", "repro_torch.data.structures",
            "repro_torch.data.crestkv",
            "repro_torch.models.embedding",
            "repro_torch.configs.shapes",
            "repro_torch.configs.seamless_m4t_large_v2",
            "repro_torch.configs.qwen2_vl_72b",
            "repro_torch.launch.mesh", "repro_torch.launch.shardings",
            "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
            "repro_torch.optim.compression",
            "repro_torch.models.spmd"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}).stdout.split()
    assert not [m for m in out if _banned(m)]


def test_chip_smoke_imports_no_jax_and_no_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names and not [n for n in names if _banned(n)]
    assert any(n.startswith("repro_torch") for n in names)
