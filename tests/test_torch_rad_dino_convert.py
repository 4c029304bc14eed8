"""The port's RAD-DINO converter (``cli/convert_rad_dino.py``, with
``utils/safetensors_io.py``) against the JAX package's
``scripts/convert_rad_dino.py`` and against Hugging Face's own forward.

No network here, so the "real" model is a randomly initialised tiny
``Dinov2Model`` saved with ``save_pretrained``, as
``tests/test_rad_dino_convert.py`` builds it. On the same directory the two
converters write byte-equal msgpack files and sidecars and equal manifests
(but for ``verified_max_abs_err``, each package's own ViT against
``Dinov2Model``). Tolerances: the port's ``DinoViT`` from the file against
the Hugging Face forward within atol 2e-4, rtol 1e-3 (the JAX script's);
arrays bit-equal after the mapping's transposes.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu_torch.cli import convert_rad_dino as C
from multimodal_edema_prediction_tpu_torch.config import ViTConfig
from multimodal_edema_prediction_tpu_torch.models.vit import (DinoViT,
                                                              load_vit_params)
from multimodal_edema_prediction_tpu_torch.train.checkpoint import \
    load_checkpoint
from multimodal_edema_prediction_tpu_torch.utils import safetensors_io as ST

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = ["--image_size", "56", "--d_model", "64", "--n_layers", "2",
            "--n_heads", "2", "--d_feedforward", "128"]
CFG = ViTConfig(image_size=56, patch_size=14, d_model=64, n_layers=2,
                n_heads=2, d_feedforward=128)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "convert_rad_dino", os.path.join(REPO, "scripts/convert_rad_dino.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """(directory, model, state dict) of a tiny seeded ``Dinov2Model``."""
    from transformers import Dinov2Config, Dinov2Model
    torch.manual_seed(0)
    model = Dinov2Model(Dinov2Config(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        mlp_ratio=2, image_size=56, patch_size=14, layerscale_value=1.0,
        hidden_act="gelu")).eval()
    d = tmp_path_factory.mktemp("hf") / "hf_model"
    model.save_pretrained(d)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return str(d), model, sd


@pytest.fixture(scope="module")
def converted(hf, tmp_path_factory):
    """Both packages' conversions of the directory, verified."""
    base = tmp_path_factory.mktemp("out")
    ours, theirs = str(base / "port.msgpack"), str(base / "jax.msgpack")
    C.main(["--source", hf[0], "--out", ours] + GEOMETRY)
    _jax_script().main(["--source", hf[0], "--out", theirs] + GEOMETRY)
    return ours, theirs


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _manifest(path):
    with open(path + ".manifest.json") as f:
        return json.load(f)


def test_port_output_equals_the_jax_scripts(converted):
    ours, theirs = converted
    assert _read(ours) == _read(theirs)
    assert _read(ours + ".config.json") == _read(theirs + ".config.json")
    a, b = _manifest(ours), _manifest(theirs)
    ea, eb = a.pop("verified_max_abs_err"), b.pop("verified_max_abs_err")
    assert a == b
    assert 0 <= ea < 2e-4 and 0 <= eb < 2e-4
    assert a["shapes"]["pos_embed"] == [1, 17, 64]
    assert a["shapes"]["patch_embed/kernel"] == [14, 14, 3, 64]
    assert a["n_params"] == sum(int(np.prod(s))
                                for s in a["shapes"].values())


def test_vit_from_the_file_matches_hugging_face(hf, converted):
    _, model, _ = hf
    vit = DinoViT(CFG)
    vit.load_state_dict(load_vit_params(converted[0], CFG))
    px = np.random.default_rng(3).random((2, 56, 56, 3)).astype(np.float32)
    with torch.no_grad():
        want = model(pixel_values=torch.from_numpy(
            px.transpose(0, 3, 1, 2).copy())).last_hidden_state.numpy()
        cls, patches = vit.eval()(torch.from_numpy(px))
    got = np.concatenate([cls.numpy()[:, None], patches.numpy()], axis=1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("kind", ["safetensors_f32", "safetensors_bf16",
                                  "pt", "pt_state_dict", "bin"])
def test_every_state_dict_file_converts(kind, hf, converted, tmp_path):
    """A bare state dict of each kind converts with no verification (it
    names no Hugging Face model); float32 ones give the directory's msgpack
    byte for byte, a BF16 file its values rounded to bfloat16."""
    from safetensors.torch import save_file
    _, _, sd = hf
    path = str(tmp_path / {"safetensors_f32": "w.safetensors",
                           "safetensors_bf16": "w.safetensors",
                           "pt": "w.pt", "pt_state_dict": "w.pt",
                           "bin": "pytorch_model.bin"}[kind])
    if kind == "safetensors_f32":
        save_file({k: v.contiguous() for k, v in sd.items()}, path)
    elif kind == "safetensors_bf16":
        save_file({k: v.to(torch.bfloat16) for k, v in sd.items()}, path)
    else:
        torch.save({"state_dict": sd} if kind == "pt_state_dict" else sd,
                   path)
    out = str(tmp_path / "vit.msgpack")
    C.main(["--source", path, "--out", out] + GEOMETRY)
    assert _manifest(out)["verified_max_abs_err"] is None
    if kind != "safetensors_bf16":
        assert _read(out) == _read(converted[0])
        return
    got = load_checkpoint(out)["params"]
    b = sd["encoder.layer.1.mlp.fc1.weight"]
    np.testing.assert_array_equal(
        got["block_1"]["mlp_in"]["kernel"],
        b.to(torch.bfloat16).float().numpy().T)
    assert got["block_1"]["mlp_in"]["kernel"].dtype == np.float32


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    """The numpy reader reads the package's files (F32, F16, BF16, I64)
    value for value; the package reads the numpy writer's."""
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file, save_file
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    tensors = {"f32": x, "f16": x.half(), "bf16": x.bfloat16(),
               "i64": torch.arange(7), "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "pkg.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = ST.load_file(path)
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        want = v.float().numpy() if k == "bf16" else v.numpy()
        assert got[k].dtype == want.dtype and np.array_equal(got[k], want), k
    mine = str(tmp_path / "mine.safetensors")
    ST.save_file({"a": x.numpy(), "b": np.arange(4, dtype=np.int32),
                  "c": x.half().numpy()}, mine, metadata={"k": "v"})
    back = load_file(mine)
    assert torch.equal(back["a"], x) and torch.equal(back["c"], x.half())
    assert np.array_equal(np_load(mine)["b"], np.arange(4))
    assert ST.read_header(mine)["__metadata__"] == {"k": "v"}
    with open(mine, "r+b") as f:
        f.truncate(os.path.getsize(mine) - 4)
    with pytest.raises(ValueError, match="spans bytes"):
        ST.load_file(mine)


def test_converts_with_no_jax_transformers_or_safetensors(hf, converted,
                                                          tmp_path):
    """In a process where jax, flax, transformers and safetensors cannot
    be imported, a directory converts to the same bytes and says it is
    unverified; the manifest's ``verified_max_abs_err`` is null."""
    out = str(tmp_path / "vit.msgpack")
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'transformers', 'safetensors'):\n"
            "    sys.modules[m] = None\n"
            "from multimodal_edema_prediction_tpu_torch.cli import "
            "convert_rad_dino as C\n"
            f"C.main({['--source', hf[0], '--out', out] + GEOMETRY!r})\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'transformers', 'safetensors', "
            "'multimodal_edema_prediction_tpu') and sys.modules[m]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    assert "UNVERIFIED: transformers is not installed" in r.stdout
    assert r.stdout.strip().splitlines()[-1] == "[]"
    assert _read(out) == _read(converted[0])
    m, want = _manifest(out), _manifest(converted[0])
    assert m.pop("verified_max_abs_err") is None
    want.pop("verified_max_abs_err")
    assert m == want


@pytest.mark.parametrize("flag,value,named", [
    ("--n_layers", "3", "encoder.layer.2.norm1.weight"),
    ("--d_feedforward", "96", "encoder.layer.0.mlp.fc1.weight"),
    ("--image_size", "70", "embeddings.position_embeddings"),
    ("--n_heads", "4", "num_attention_heads")])
def test_a_wrong_geometry_raises_naming_the_array(flag, value, named, hf,
                                                  tmp_path):
    argv = list(GEOMETRY)
    argv[argv.index(flag) + 1] = value
    out = str(tmp_path / "vit.msgpack")
    with pytest.raises(ValueError) as e:
        C.main(["--source", hf[0], "--out", out] + argv)
    assert named in str(e.value)
    assert not os.path.exists(out)


def test_hub_id_resolves_only_in_a_local_cache(hf, converted, tmp_path,
                                               monkeypatch):
    """A hub id is looked up in the local caches only: with none it raises
    naming each path it looked in; a cache holding the snapshot converts
    it to the directory's bytes, the manifest naming the hub id."""
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    out = str(tmp_path / "vit.msgpack")
    with pytest.raises(FileNotFoundError) as e:
        C.main(["--source", "microsoft/rad-dino", "--out", out] + GEOMETRY)
    for where in (tmp_path / "hf_home" / "hub", home / ".cache" /
                  "huggingface" / "hub"):
        assert str(where / "models--microsoft--rad-dino" / "snapshots") \
            in str(e.value)
    repo = tmp_path / "hf_home" / "hub" / "models--microsoft--rad-dino"
    snap = repo / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    for name in os.listdir(hf[0]):
        os.symlink(os.path.join(hf[0], name), snap / name)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("abc123")
    C.main(["--source", "microsoft/rad-dino", "--out", out, "--skip_verify"]
           + GEOMETRY)
    assert _read(out) == _read(converted[0])
    assert _manifest(out)["source"] == "microsoft/rad-dino"


def test_preprocessor_config_gives_the_norm_constants(hf, tmp_path):
    d = tmp_path / "with_pre"
    d.mkdir()
    for name in os.listdir(hf[0]):
        os.symlink(os.path.join(hf[0], name), d / name)
    (d / "preprocessor_config.json").write_text(json.dumps(
        {"image_mean": [0.1, 0.2, 0.3], "image_std": [0.4, 0.5, 0.6]}))
    out = str(tmp_path / "vit.msgpack")
    C.main(["--source", str(d), "--out", out, "--skip_verify"] + GEOMETRY)
    m = _manifest(out)
    assert m["image_mean"] == [0.1, 0.2, 0.3]
    assert m["image_std"] == [0.4, 0.5, 0.6]
    assert load_checkpoint(out)["config"]["image_std"] == [0.4, 0.5, 0.6]


def test_teacher_cli_loads_the_converted_vit(converted, tmp_path):
    """``cli.train_teacher --vit_weights`` on the CPU starts the frozen
    CXR branch from the file, and the trained checkpoint keeps it bit for
    bit."""
    import glob
    from multimodal_edema_prediction_tpu_torch.cli import train_teacher
    ckpt = str(tmp_path / "run")
    train_teacher.main(["--device", "cpu", "--vit_size", "tiny",
                        "--synthetic_stays", "60", "--batch_size", "16",
                        "--epochs", "1", "--limit_batches", "1",
                        "--no_save_state", "--vit_weights", converted[0],
                        "--ckpt_dir", ckpt])
    best = glob.glob(os.path.join(ckpt, "*", "best-*.msgpack"))
    assert len(best) == 1
    cxr = load_checkpoint(best[0])["params"]["cxr"]
    src = load_checkpoint(converted[0])["params"]
    flat_a, flat_b = C.flat_shapes(cxr), C.flat_shapes(src)
    assert flat_a == flat_b

    def leaves(t, p=""):
        for k in sorted(t):
            if isinstance(t[k], dict):
                yield from leaves(t[k], f"{p}{k}/")
            else:
                yield p + k, t[k]

    for (ka, a), (kb, b) in zip(leaves(cxr), leaves(src)):
        assert ka == kb and a.tobytes() == b.tobytes(), ka
