"""The port stands alone: importing every module of it, and what
``chip_smoke.py`` imports, brings in neither JAX nor flax nor msgpack nor the
JAX package; its entry points default to the card; and its attention wrapper
takes the plain version only for CPU tensors."""
import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import multimodal_edema_prediction_tpu_torch as port
from multimodal_edema_prediction_tpu_torch.cli import serve as cli_serve
from multimodal_edema_prediction_tpu_torch.ops import attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack",
             "multimodal_edema_prediction_tpu")


def _all_port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix=port.__name__ + "."))


def test_imports_bring_in_no_jax():
    mods = _all_port_modules()
    assert "multimodal_edema_prediction_tpu_torch.serve.predictor" in mods
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "chip_smoke.import_port()\n"
        f"print(json.dumps(sorted(n for n in sys.modules if n.split('.')[0]"
        f" in {FORBIDDEN!r})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_name_no_jax_import():
    """No import statement of the forbidden packages anywhere in the port's
    sources or chip_smoke.py (also covers code behind function-level
    imports that the import test above does not execute)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.dirname(port.__file__)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            for ln in f:
                words = ln.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0].rstrip(",")
                    assert top not in FORBIDDEN, f"{path}: {ln.strip()}"


def test_cli_device_default_is_cuda():
    args = cli_serve.build_parser().parse_args(["--ckpt", "x.msgpack"])
    assert args.device == "cuda"
    assert args.image_mode == "pixel"


@pytest.mark.parametrize("mode", ["jpeg_root", "synthetic"])
def test_cli_queued_image_modes_raise(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli_serve.main(["--ckpt", "x.msgpack", "--image_mode", mode])


def test_flash_wrapper_plain_path_is_cpu_only(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("plain version taken for a non-CPU tensor")

    monkeypatch.setattr(attention, "flash_mha_reference", forbidden)
    q = torch.empty(1, 2, 300, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        attention.flash_mha(q, q, q, 0.125)
    cpu = torch.zeros(1, 2, 300, 64)
    with pytest.raises(AssertionError, match="plain version taken"):
        attention.flash_mha(cpu, cpu, cpu, 0.125)   # CPU does take it
