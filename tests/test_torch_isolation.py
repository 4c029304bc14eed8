"""The port stands alone: importing every module of it, and what
``chip_smoke.py`` imports, brings in neither JAX nor flax nor optax nor
msgpack nor sklearn nor ml_dtypes nor the JAX package; its entry points
default to the card; and its kernel wrappers take their plain versions only
for CPU tensors."""
import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import multimodal_edema_prediction_tpu_torch as port
from multimodal_edema_prediction_tpu_torch.cli import serve as cli_serve
from multimodal_edema_prediction_tpu_torch.cli import train_ssl as cli_ssl
from multimodal_edema_prediction_tpu_torch.cli import train_teacher as cli_train
from multimodal_edema_prediction_tpu_torch.ops import (attention, dual_axis,
                                                       gather, ln_qkv)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "sklearn",
             "ml_dtypes", "multimodal_edema_prediction_tpu")


def _all_port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix=port.__name__ + "."))


def test_imports_bring_in_no_jax():
    mods = _all_port_modules()
    for name in ("serve.predictor", "ops.gather", "ops.attention",
                 "ops.dual_axis", "ops.ln_qkv", "data.features",
                 "data.sliding", "train.teacher_loop", "train.ssl_loop",
                 "cli.train_teacher", "cli.train_ssl", "models.student",
                 "train.kd_loop", "cli.train_student", "utils.preemption",
                 "models.cxr_head", "train.cxr_head_loop",
                 "cli.train_cxr_head", "models.perceiver", "models.teacher",
                 "train.engine", "train.evaluator", "ops.losses"):
        assert f"multimodal_edema_prediction_tpu_torch.{name}" in mods
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import chip_smoke\n"
        "chip_smoke.import_port()\n"
        f"missing = [m for m in {mods!r} if m not in sys.modules]\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"print(json.dumps([missing, sorted(n for n in sys.modules if "
        f"n.split('.')[0] in {FORBIDDEN!r})]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    # chip_smoke.import_port() covers every module of the port, and nothing
    # of the port brings in a forbidden package
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], []]


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


def test_train_cli_device_default_is_cuda(tmp_path):
    args = cli_train.build_parser().parse_args([])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--vit_size", "tiny", "--synthetic_stays", "40",
                        "--ckpt_dir", str(tmp_path)])


@pytest.mark.parametrize("argv", [
    ["--perceiver_type", "single"], ["--perceiver_type", "legacy"],
    ["--perceiver_type", "dual_patch_event"],
    ["--perceiver_type", "dual_patch_event", "--lp_only_correction",
     "--lp_ckpt", "x.msgpack"]])
def test_every_teacher_mode_defaults_to_the_card(argv, tmp_path):
    """The other teacher modes and LP mode run on the card unless the CPU
    is asked for: without one they raise before any model work."""
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--vit_size", "tiny", "--synthetic_stays", "40",
                        "--ckpt_dir", str(tmp_path)] + argv)


def test_ssl_cli_device_default_is_cuda(tmp_path):
    assert cli_ssl.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_ssl.main(["--synthetic_stays", "40", "--n_variables", "6",
                      "--ckpt_dir", str(tmp_path)])


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


def test_flash_backward_plain_path_is_cpu_only(monkeypatch):
    """The gradient's plain version too runs only for CPU tensors."""
    def forbidden(*a, **k):
        raise AssertionError("plain backward taken for a non-CPU tensor")

    monkeypatch.setattr(attention, "flash_mha_backward_reference", forbidden)
    q = torch.empty(1, 2, 300, 64, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        attention.flash_mha(q, q, q, 0.125)
    cpu = torch.zeros(1, 2, 300, 64, requires_grad=True)
    out = attention.flash_mha(cpu, cpu, cpu, 0.125)
    with pytest.raises(AssertionError, match="plain backward taken"):
        out.sum().backward()                        # CPU does take it


def test_every_kernel_source_is_built():
    """``ops/build.py`` builds every CUDA source of ``csrc/`` (what
    ``chip_smoke.py`` compiles), the backward kernels' among them."""
    from multimodal_edema_prediction_tpu_torch.ops import build
    sources = sorted(f for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    assert sorted(build.SOURCES.values()) == sources
    for name in ("flash_attention_bwd.cu", "dual_axis_block.cu", "ln_qkv.cu"):
        assert name in sources


def test_gather_wrapper_plain_path_is_cpu_only(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("plain version taken for a non-CPU tensor")

    monkeypatch.setattr(gather, "gather_rows_reference", forbidden)
    rows = torch.zeros(2, dtype=torch.int32)
    for bank in (torch.empty(4, 3, 8, device="meta"),
                 torch.empty(4, 8, device="meta")):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            gather.gather_rows(bank, rows.to("meta"))
    with pytest.raises(AssertionError, match="plain version taken"):
        gather.gather_rows(torch.zeros(4, 3, 8), rows)   # CPU does take it


def _dual_axis_params(device, D=8, inner=4, F=16):
    def z(*s):
        return torch.zeros(*s, device=device)
    return {"g1": z(1), "g2": z(1), "gf": z(1), "wq": z(D, inner),
            "wk": z(D, inner), "wv": z(D, inner), "wo": z(inner, D),
            "bo": z(D), "w1": z(D, F), "b1": z(F), "w2": z(F, D), "b2": z(D)}


def _ln_qkv_params(device, D=8, inner=64):
    def z(*s):
        return torch.zeros(*s, device=device)
    return {"ln_scale": z(D), "ln_bias": z(D), "wq": z(D, inner),
            "wk": z(D, inner), "wv": z(D, inner), "bq": z(inner),
            "bk": z(inner), "bv": z(inner)}


@pytest.mark.parametrize("grad", [False, True])
def test_dual_axis_wrapper_plain_path_is_cpu_only(monkeypatch, grad):
    """K3's plain version runs only for CPU tensors, forward and (through
    the autograd Function) backward alike."""
    def forbidden(*a, **k):
        raise AssertionError("plain version taken")

    monkeypatch.setattr(dual_axis, "encoder_block_reference", forbidden)
    x = torch.empty(2, 5, 8, device="meta", requires_grad=grad)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        dual_axis.fused_encoder_block(x, _dual_axis_params("meta"), 2, 2)
    cpu = torch.zeros(2, 5, 8, requires_grad=grad)
    with pytest.raises(AssertionError, match="plain version taken"):
        dual_axis.fused_encoder_block(cpu, _dual_axis_params("cpu"), 2, 2)


@pytest.mark.parametrize("grad", [False, True])
def test_ln_qkv_wrapper_plain_path_is_cpu_only(monkeypatch, grad):
    def forbidden(*a, **k):
        raise AssertionError("plain version taken")

    monkeypatch.setattr(ln_qkv, "ln_qkv_reference", forbidden)
    x = torch.empty(2, 5, 8, device="meta", requires_grad=grad)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ln_qkv.fused_ln_qkv(x, _ln_qkv_params("meta"), 1, 64)
    cpu = torch.zeros(2, 5, 8, requires_grad=grad)
    with pytest.raises(AssertionError, match="plain version taken"):
        ln_qkv.fused_ln_qkv(cpu, _ln_qkv_params("cpu"), 1, 64)
