"""The port stands alone: importing every module of it, and what
``chip_smoke.py`` imports, brings in neither JAX nor flax nor optax nor
msgpack nor sklearn nor ml_dtypes nor PIL nor pandas nor pyarrow (the L0
chain, ``data/raw_mimic.py``, is numpy only) nor zstandard, lz4 or
flatbuffers (``data/arrow_ipc.py`` reads and writes feather with the
port's own codecs) nor orbax, tensorstore, zarr or numcodecs
(``train/orbax_io.py`` reads and writes orbax's layout itself) nor
safetensors (``utils/safetensors_io.py`` reads and writes it in numpy) nor
the JAX package, nor umap-learn, nor matplotlib or scipy (which the
analysis scripts import only inside the functions that draw a figure or
fit a probe), nor transformers (imported only inside
``cli/convert_rad_dino.verify``), nor wandb
(imported only inside ``utils/logging.Logger``; ``torch.profiler``, which
torch itself loads, is imported only inside ``utils/profiling.trace``),
and no module of it loads the JAX package's native library; its entry points
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
             "ml_dtypes", "PIL", "pandas", "pyarrow", "umap", "zstandard",
             "lz4", "flatbuffers", "orbax", "tensorstore", "zarr",
             "numcodecs", "safetensors", "multimodal_edema_prediction_tpu")
# imported inside a function only, never when a module is imported
LAZY = ("matplotlib", "scipy", "wandb", "transformers")


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
                 "train.engine", "train.evaluator", "ops.losses",
                 "data.images", "data.native_loader", "data.prefetch",
                 "ops.jpeg", "analysis.common", "cli.predict",
                 "cli.finetune_mimic", "cli.train_physionet",
                 "data.physionet", "train.finetune_loop",
                 "analysis.trajectory_availability",
                 "analysis.residual_by_confidence",
                 "analysis.complementarity", "analysis.logit_fusion_probe",
                 "analysis.diagnose_temporal_usage",
                 "analysis.unimodal_linear_probe",
                 "analysis.grad_flow_diagnostics",
                 "analysis.why_we_need_multimodal", "models.trajectory",
                 "analysis.train_trajectory_probe",
                 "analysis.conditional_information_probe",
                 "analysis.raw_trajectory_conditional_probe",
                 "analysis.umap_impl", "analysis.tsne",
                 "analysis.visualize_pathology", "ops.int8",
                 "ops.lupi_losses", "utils.logging", "utils.profiling",
                 "data.frames", "data.raw_mimic", "data.synthetic_raw",
                 "data.static_info", "data.cxr_catalog", "data.preprocess",
                 "data.demographics", "data.subtype", "data.prompts",
                 "data.reports", "data.text_embeddings", "data.jpeg_writer",
                 "cli.preprocess", "data.arrow_ipc", "utils.lz4",
                 "utils.zstd", "utils.xxhash", "utils.crc32c",
                 "utils.ocdbt", "utils.zarr2", "train.orbax_io",
                 "cli.convert_rad_dino", "utils.safetensors_io"):
        assert f"multimodal_edema_prediction_tpu_torch.{name}" in mods
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import chip_smoke\n"
        "chip_smoke.import_port()\n"
        f"missing = [m for m in {mods!r} if m not in sys.modules]\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"print(json.dumps([missing, sorted(n for n in sys.modules if "
        f"n.split('.')[0] in {FORBIDDEN + LAZY!r})]))\n")
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


def test_wandb_and_the_profiler_are_imported_inside_functions():
    """No module-level import of wandb or ``torch.profiler`` in the port or
    chip_smoke.py: the logger and ``trace`` import them when called."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.dirname(port.__file__)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            for ln in f:
                words = ln.replace(",", " ").split()
                if ln[:1].isspace() or words[:1] not in (["import"],
                                                         ["from"]):
                    continue
                mods = words[1:] if words[0] == "import" else \
                    [words[1]] + [f"{words[1]}.{n}" for n in words[3:]]
                assert not any(m.split(".")[0] == "wandb"
                               or m.startswith("torch.profiler")
                               for m in mods), f"{path}: {ln.strip()}"


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


@pytest.mark.parametrize("cli,argv", [
    ("finetune_mimic", ["--synthetic_stays", "40", "--n_variables", "6"]),
    ("train_physionet", ["--n_patients", "20"]),
    ("predict", ["--ckpt", "x.msgpack"])])
def test_supervised_and_predict_clis_default_to_the_card(cli, argv,
                                                         tmp_path):
    """The P14 CLIs and ``cli.predict`` run on the card unless the CPU is
    asked for: without one they raise before any model work."""
    import importlib
    mod = importlib.import_module(
        f"multimodal_edema_prediction_tpu_torch.cli.{cli}")
    assert mod.build_parser().parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        return
    extra = [] if cli == "predict" else ["--ckpt_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv + extra)


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.dirname(port.__file__)):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cpp", ".cu", ".cuh"))]
    return files


def test_no_port_module_loads_the_jax_packages_native_library():
    """The port builds its own decoder (``csrc/host/jpeg_decode.cpp``) and
    never names ``native/`` or its library."""
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        assert "libmmedema_native" not in text, path
        assert '"native"' not in text and "'native'" not in text, path


@pytest.mark.parametrize("mode", ["jpeg_root", "synthetic"])
def test_cli_queued_image_modes_raise(mode):
    """Both modes once queued are ported: ``jpeg_root`` is, as in the JAX
    CLI, an argument error without ``--cxr_jpeg_root``; ``synthetic``
    (P17, ported) is refused by no item and goes on to read the checkpoint,
    which here does not exist."""
    if mode == "jpeg_root":
        with pytest.raises(SystemExit):
            cli_serve.main(["--ckpt", "x.msgpack", "--image_mode", mode])
        return
    with pytest.raises(FileNotFoundError, match="x.msgpack"):
        cli_serve.main(["--ckpt", "x.msgpack", "--image_mode", mode,
                        "--device", "cpu"])


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
