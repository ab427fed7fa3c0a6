"""awesome_tpu_torch stands alone: it imports without JAX, none of its
modules imports JAX or the JAX package, and its entry points run on CUDA
unless the caller asks for the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import awesome_tpu_torch
from torch_one_thread import one_torch_thread  # noqa: F401

PKG = pathlib.Path(awesome_tpu_torch.__file__).resolve().parent
MODULES = sorted(
    "awesome_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['awesome_tpu'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.')\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    root = str(PKG.parent)
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_names_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "awesome_tpu"), (path, name)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from awesome_tpu_torch.bridge import params_from_jax
    from awesome_tpu_torch.core import grids
    from awesome_tpu_torch.nn.path_connected import (
        real_nvp_path_connected_net,
    )

    with pytest.raises(RuntimeError, match="device='cpu'"):
        real_nvp_path_connected_net(spatial_shape=(8, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        grids.pixel_grid((4, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"w": [1.0]})
    model = real_nvp_path_connected_net(spatial_shape=(8, 8), device="cpu")
    assert model.device.type == "cpu"
    assert model.flow_net.masks.device.type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
