"""Fault F3: every flag of the JAX package's CLIs parses in the port's.

The JAX parsers of ``cli/train_teacher``, ``cli/train_ssl``,
``cli/train_student``, ``cli/train_cxr_head``, ``cli/serve``,
``cli/finetune_mimic``, ``cli/train_physionet``, ``cli/predict`` and
``cli/preprocess`` are
collected by intercepting
``parse_args``, as ``tests/test_flag_parity.py:39-64`` collects the
reference's. Each of their
flags is either accepted by the port with the JAX default, or listed in
``WAIVERS`` with the ROADMAP item that ports it; a waived flag, when given
(with a value the JAX parser takes), raises ``NotImplementedError`` naming
that item right after parsing, before any data, model or device work.
``--eval_train_batches`` is ported: one CPU teacher run shows the
train-subset evaluation and its gap table. The teacher's P13 flags (the
other modes and LP mode) and P15 flags (the image feed tiers), and
serving's ``--cxr_jpeg_root`` (P15) and ``--data_parallel`` (P18), were
waived until their items were done;
each now reaches the configuration, the loop's arguments or the server's
startup (``PORTED``). The P14 and P17 CLIs' flags each reach their loop's
or their eval's arguments (``SUPERVISED_PORTED``, ``PREDICT_PORTED``).
The analysis scripts of P19a and P19b take every flag of their JAX
counterparts;
the teacher's ``--grad_diag_every`` and ``--grad_diag_batches`` (waived
until P19a) reach the loop's arguments. The logging flags (waived until
P20) reach the CLI's ``Logger`` (``--wandb_project``, off under
``--wandb_disabled``; ``--wandb_run_name``) or ``TrainConfig.log_every``
(``LOGGING_PORTED``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.analysis import (
    complementarity as jax_complementarity,
    conditional_information_probe as jax_conditional,
    diagnose_temporal_usage as jax_diagnose,
    grad_flow_diagnostics as jax_grad_flow,
    logit_fusion_probe as jax_logit_probe,
    raw_trajectory_conditional_probe as jax_raw_probe,
    residual_by_confidence as jax_residual,
    train_trajectory_probe as jax_trajectory_probe,
    trajectory_availability as jax_trajectory,
    unimodal_linear_probe as jax_unimodal, visualize_pathology as jax_viz,
    why_we_need_multimodal as jax_why)
from multimodal_edema_prediction_tpu.cli import \
    finetune_mimic as jax_finetune
from multimodal_edema_prediction_tpu.cli import predict as jax_predict
from multimodal_edema_prediction_tpu.cli import preprocess as jax_preprocess
from multimodal_edema_prediction_tpu.cli import serve as jax_serve
from multimodal_edema_prediction_tpu.cli import train_cxr_head as jax_cxr_head
from multimodal_edema_prediction_tpu.cli import \
    train_physionet as jax_physionet
from multimodal_edema_prediction_tpu.cli import train_ssl as jax_ssl
from multimodal_edema_prediction_tpu.cli import train_student as jax_student
from multimodal_edema_prediction_tpu.cli import train_teacher as jax_teacher
from multimodal_edema_prediction_tpu_torch.analysis import (
    complementarity, conditional_information_probe, diagnose_temporal_usage,
    grad_flow_diagnostics, logit_fusion_probe,
    raw_trajectory_conditional_probe, residual_by_confidence,
    train_trajectory_probe, trajectory_availability, unimodal_linear_probe,
    visualize_pathology, why_we_need_multimodal)
from multimodal_edema_prediction_tpu_torch.cli import (finetune_mimic,
                                                       predict, preprocess,
                                                       serve,
                                                       train_cxr_head,
                                                       train_physionet,
                                                       train_ssl)
from multimodal_edema_prediction_tpu_torch.cli import (train_student,
                                                       train_teacher)
from multimodal_edema_prediction_tpu_torch.train.teacher_loop import \
    load_teacher_from_ckpt

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The CLI runs here train tiny models, which gain nothing from
    intra-op threads, and the suite runs several test processes on the
    host's cores at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CLIS = {"train_teacher": (jax_teacher, train_teacher),
        "train_ssl": (jax_ssl, train_ssl),
        "train_student": (jax_student, train_student),
        "train_cxr_head": (jax_cxr_head, train_cxr_head),
        "serve": (jax_serve, serve),
        "finetune_mimic": (jax_finetune, finetune_mimic),
        "train_physionet": (jax_physionet, train_physionet),
        "predict": (jax_predict, predict),
        # the L0 CLI of ROADMAP P21
        "preprocess": (jax_preprocess, preprocess),
        # the analysis scripts of ROADMAP P19a
        "trajectory_availability": (jax_trajectory, trajectory_availability),
        "residual_by_confidence": (jax_residual, residual_by_confidence),
        "complementarity": (jax_complementarity, complementarity),
        "logit_fusion_probe": (jax_logit_probe, logit_fusion_probe),
        "diagnose_temporal_usage": (jax_diagnose, diagnose_temporal_usage),
        "unimodal_linear_probe": (jax_unimodal, unimodal_linear_probe),
        "grad_flow_diagnostics": (jax_grad_flow, grad_flow_diagnostics),
        "why_we_need_multimodal": (jax_why, why_we_need_multimodal),
        # ... and of P19b
        "conditional_information_probe": (jax_conditional,
                                          conditional_information_probe),
        "raw_trajectory_conditional_probe": (
            jax_raw_probe, raw_trajectory_conditional_probe),
        "visualize_pathology": (jax_viz, visualize_pathology),
        "train_trajectory_probe": (jax_trajectory_probe,
                                   train_trajectory_probe)}
# what a CLI needs before the flag under test (serve's and predict's --ckpt
# and the student's --teacher_ckpt are required)
REQUIRED = {"serve": ["--ckpt", "x.msgpack"],
            "predict": ["--ckpt", "x.msgpack"],
            "train_student": ["--teacher_ckpt", "x.msgpack"]}
# ... and the port's training CLIs would otherwise default to the card
BASE = {cli: REQUIRED.get(cli, []) + ["--device", "cpu"] for cli in CLIS}

# JAX flag → the ROADMAP item that ports it
WAIVERS = {
    "train_teacher": {},
    "train_ssl": {},
    "train_student": {},
    "train_cxr_head": {},
    "serve": {},
    "finetune_mimic": {},
    "train_physionet": {},
    "predict": {},
    **{cli: {} for cli in CLIS if cli not in (
        "train_teacher", "train_ssl", "train_student", "train_cxr_head",
        "serve", "finetune_mimic", "train_physionet", "predict")},
}


# the teacher's flags that ROADMAP P13 waived until it was done → where each
# given value lands: the configs of ``cli/common.configs_from_args`` and
# ``cli/train_teacher.teacher_config``, or ``train_teacher``'s LP arguments
PORTED = {
    "--n_latents": lambda c: c["teacher"].perceiver.n_latents,
    "--n_perceiver_layers": lambda c: c["teacher"].perceiver.n_layers,
    "--aux_stage2_alpha": lambda c: c["train"].aux_stage2_alpha,
    "--aux_stage4_alpha": lambda c: c["train"].aux_stage4_alpha,
    "--use_aux_cxr": lambda c: c["train"].use_aux_cxr,
    "--aux_cxr_alpha": lambda c: c["train"].aux_cxr_alpha,
    "--lp_ckpt": lambda c: c["lp"]["lp_from"],
    "--lp_beta_l2": lambda c: c["lp"]["lp_beta_l2"],
    "--lp_corr_l2": lambda c: c["lp"]["lp_corr_l2"],
    "--lp_correction_dropout":
        lambda c: c["teacher"].perceiver.correction_dropout,
    # P15: the image feed tiers, into train_teacher's arguments
    "--image_bank": lambda c: c["images"]["image_bank"],
    "--hbm_image_budget_gb": lambda c: c["images"]["hbm_image_budget_gb"],
    "--u8_store_path": lambda c: c["images"]["u8_store_path"],
    "--prefetch_depth": lambda c: c["images"]["prefetch_depth"],
}
# serving's flags waived until their item (P15, P18) was done
SERVE_PORTED = ("--cxr_jpeg_root", "--data_parallel", "--aot_dir")
# the logging flags waived until P20 was done: (cli, flag) → the argv that
# gives it and what it must set: the ``Logger``'s project or run name, or
# the loop's ``TrainConfig.log_every``
_LOGGING = {
    "--log_every": (["--log_every", "7"], "log_every", 7),
    "--wandb_project": (["--wandb_project", "proj"], "project", "proj"),
    "--wandb_run_name": (["--wandb_run_name", "run"], "run_name", "run"),
    "--wandb_disabled": (["--wandb_project", "proj", "--wandb_disabled"],
                         "project", None),
}
LOGGING_PORTED = {
    **{(cli, flag): want for cli in ("train_teacher", "train_ssl",
                                     "train_student")
       for flag, want in _LOGGING.items()},
    ("finetune_mimic", "--wandb_project"): _LOGGING["--wandb_project"],
}
# each CLI's loop, and where its TrainConfig sits among the loop's arguments
LOOPS = {"train_teacher": ("train_teacher", 2),
         "train_ssl": ("train_ssl", 2),
         "train_student": ("train_student_kd", 3),
         "finetune_mimic": ("finetune_duett", 2)}


class _Stop(Exception):
    pass


def _parser(mod) -> argparse.ArgumentParser:
    """The parser ``mod.main`` builds, caught at its ``parse_args``."""
    caught = []
    orig = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        caught.append(self)
        raise _Stop

    argparse.ArgumentParser.parse_args = grab
    try:
        mod.main([])
    except _Stop:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    assert len(caught) == 1
    return caught[0]


def _actions(parser) -> dict:
    return {s: a for a in parser._actions for s in a.option_strings
            if s.startswith("--")}


def _given(action, flag: str) -> list:
    """``flag`` as a user would give it: with a value the action takes."""
    if action.nargs == 0:
        return [flag]
    if action.choices:
        return [flag, str(action.choices[0])]
    return [flag, "1" if action.type in (int, float) else "x"]


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_every_jax_flag_parses_or_is_waived(cli):
    """No JAX flag makes the port's argparse exit: each is defined, with
    the JAX default where it is accepted; every waiver names a JAX flag."""
    jax_mod, port_mod = CLIS[cli]
    ours, theirs = _actions(_parser(port_mod)), _actions(_parser(jax_mod))
    assert not sorted(set(theirs) - set(ours))
    assert not sorted(set(WAIVERS[cli]) - set(theirs))
    for flag, action in theirs.items():
        if flag in WAIVERS[cli]:
            assert ours[flag].default is argparse.SUPPRESS, flag
        else:
            assert ours[flag].dest == action.dest, flag
            assert ours[flag].default == action.default, flag


@pytest.mark.parametrize("cli,flag", sorted(
    [(c, f) for c in WAIVERS for f in WAIVERS[c]]
    + [("train_teacher", f) for f in PORTED]
    + [("serve", f) for f in SERVE_PORTED]))
def test_waived_flag_raises_naming_its_item(cli, flag):
    """A waived flag raises naming its item; a flag of ``PORTED`` (waived
    until its item was done) parses to the value given, which reaches the
    configs, the LP arguments or the image arguments, with
    ``--lp_only_correction`` (JAX sets LP mode's dropout and checkpoint
    only with it); serving's ``--cxr_jpeg_root``, ``--data_parallel`` and
    ``--aot_dir`` (``SERVE_PORTED``) parse to the value given, and the
    first is read by ``--image_mode jpeg_root``'s startup, which refuses a
    directory without JPEGs."""
    jax_mod, port_mod = CLIS[cli]
    argv = _given(_actions(_parser(jax_mod))[flag], flag)
    # a valid JAX invocation
    _parser(jax_mod).parse_args(REQUIRED.get(cli, []) + argv)
    if cli == "serve" and flag in SERVE_PORTED:
        args = port_mod.build_parser().parse_args(REQUIRED[cli] + argv)
        got = getattr(args, flag[2:])
        assert got == type(got)(argv[1])
        return
    if flag in PORTED:
        from multimodal_edema_prediction_tpu_torch.cli.common import \
            configs_from_args
        from multimodal_edema_prediction_tpu_torch.config import ViTConfig
        args = port_mod.build_parser().parse_args(
            argv + ["--lp_only_correction"])
        dcfg, duett, train = configs_from_args(args)
        got = PORTED[flag]({
            "train": train, "lp": port_mod.lp_kwargs(args),
            "images": port_mod.image_kwargs(args),
            "teacher": port_mod.teacher_config(args, dcfg, duett,
                                               ViTConfig())})
        want = True if len(argv) == 1 else type(got)(argv[1])
        assert got == want, (flag, got)
        return
    with pytest.raises(NotImplementedError,
                       match=f"{flag}.*ROADMAP {WAIVERS[cli][flag]}"):
        port_mod.main(BASE[cli] + argv)


@pytest.mark.parametrize("cli,flag", sorted(LOGGING_PORTED))
def test_logging_flags_reach_the_logger(cli, flag, monkeypatch, tmp_path):
    """A logging flag (waived until P20) as the JAX CLI takes it reaches the
    CLI's ``Logger`` (``wandb_project`` gated by ``--wandb_disabled``, JAX
    ``cli/common.py:80-84``; the run name) or the loop's
    ``TrainConfig.log_every``."""
    argv, what, want = LOGGING_PORTED[(cli, flag)]
    jax_mod, port_mod = CLIS[cli]
    _parser(jax_mod).parse_args(REQUIRED.get(cli, []) + argv)
    made = {}

    class Recorder:
        def __init__(self, name, wandb_project=None, wandb_run_name=None,
                     config=None):
            made.update(project=wandb_project, run_name=wandb_run_name)

        def info(self, msg):
            pass

    monkeypatch.setattr(port_mod, "Logger", Recorder)
    loop, at = LOOPS[cli]
    seen = _catch(monkeypatch, port_mod, loop)
    with pytest.raises(_Caught):
        port_mod.main(BASE[cli] + ["--synthetic_stays", "40", "--ckpt_dir",
                                   str(tmp_path)] + argv)
    got = seen["args"][at].log_every if what == "log_every" else made[what]
    assert got == want, (cli, flag, got)


@pytest.mark.parametrize("cli", ["train_teacher", "train_ssl"])
def test_accepted_flags_reach_the_configs(cli):
    """``--synthetic``, ``--eval_train_batches`` and ``--steps_per_call``
    (no longer queued since P10) as JAX takes them (``cli/common.py:25,
    :55, :62, :105``); the teacher's ``--flash_block_b`` (a TPU tuning
    knob) is parsed and ignored."""
    from multimodal_edema_prediction_tpu_torch.cli.common import \
        configs_from_args
    port_mod = CLIS[cli][1]
    argv = ["--synthetic", "--eval_train_batches", "3", "--steps_per_call",
            "4"]
    if cli == "train_teacher":
        argv += ["--flash_block_b", "4", "--no_save_state"]
    args = port_mod.build_parser().parse_args(argv)
    assert args.synthetic is True
    assert configs_from_args(args)[2].eval_train_batches == 3
    assert configs_from_args(args)[2].steps_per_call == 4
    if cli == "train_teacher":
        assert args.flash_block_b == 4 and args.save_state is False


@pytest.mark.parametrize("extra,says", [([], True), (["--no_save_state"],
                                                     False)])
def test_save_state_default_says_no_state_is_written(extra, says, capsys,
                                                     tmp_path):
    """``--save_state`` (the JAX default) now writes the full train state
    into the run directory, which ``--resume_dir`` continues;
    ``--no_save_state`` writes none; neither prints the note that stood
    here before teacher resume was ported."""
    train_teacher.main(["--device", "cpu", "--vit_size", "tiny",
                        "--synthetic_stays", "40", "--batch_size", "16",
                        "--epochs", "1", "--limit_batches", "1",
                        "--cxr_feature_cache", "hbm",
                        "--ckpt_dir", str(tmp_path)] + extra)
    assert "no full train state is written" not in capsys.readouterr().out
    (run_dir,) = [tmp_path / d for d in os.listdir(tmp_path)]
    files = set(os.listdir(run_dir))
    assert ({"train_state.msgpack", "train_state.meta.json"} <= files) \
        == says


def test_eval_train_batches_on_the_cpu_teacher_loop(tmp_path, capsys):
    """``--eval_train_batches 2``: after each epoch the loop evaluates two
    train batches and prints their gap table (JAX
    ``teacher_loop.py:656-675``); its reading is the port's evaluator on
    the same batches of the epoch's weights."""
    res = train_teacher.main([
        "--device", "cpu", "--vit_size", "tiny", "--synthetic_stays", "60",
        "--batch_size", "16", "--epochs", "2", "--limit_batches", "2",
        "--warmup_steps", "2", "--cxr_feature_cache", "hbm",
        "--mixed_precision", "no", "--eval_train_batches", "2",
        "--ckpt_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("train-subset gap table:") == 2
    assert len(res.history) == 2
    for h in res.history:
        assert np.isfinite(h["train_eval_main_auroc"])
        assert h["train_eval_main_gap_over_val"] == pytest.approx(
            h["train_eval_main_auroc"] - h["val_main_auroc"])
    best = int(np.argmax([h["val_main_auroc"] for h in res.history]))
    model, _, _ = load_teacher_from_ckpt(res.best_path, device="cpu")
    again = res.extras["evaluate"](model, "train", limit=2)
    assert again["n"] == 32
    assert again["main_auroc"] == res.history[best]["train_eval_main_auroc"]


@pytest.mark.parametrize("argv,kw", [
    (["--image_bank", "stream"], {"image_bank": "stream"}),
    (["--hbm_image_budget_gb", "0.25"], {"hbm_image_budget_gb": 0.25}),
    (["--u8_store_path", "/s/u8"], {"u8_store_path": "/s/u8"}),
    (["--prefetch_depth", "0"], {"prefetch_depth": 0}),
    (["--cxr_jpeg_root", "/j"], {"jpeg_store": "/j"}),
    # P19a: the loop's gradient-flow diagnostics
    (["--grad_diag_every", "2"], {"grad_diag_every": 2}),
    (["--grad_diag_batches", "3"], {"grad_diag_batches": 3})])
def test_image_flags_reach_the_loop(argv, kw, monkeypatch, tmp_path):
    """Each P15 flag's value, given to the CLI, is what ``train_teacher``
    is called with (the JPEG root as its ``JpegStore``'s root); so are the
    P19a flags ``--grad_diag_every`` and ``--grad_diag_batches``."""
    seen = {}

    class Stop(Exception):
        pass

    def fake(*a, **k):
        seen.update(k)
        raise Stop

    monkeypatch.setattr(train_teacher, "train_teacher", fake)
    with pytest.raises(Stop):
        train_teacher.main(["--device", "cpu", "--vit_size", "tiny",
                            "--synthetic_stays", "40", "--ckpt_dir",
                            str(tmp_path)] + argv)
    for k, v in kw.items():
        got = seen[k].root if k == "jpeg_store" else seen[k]
        assert got == v, (k, got)


def test_cli_trains_from_a_jpeg_directory_on_the_u8_store(tmp_path):
    """``--cxr_jpeg_root --image_bank stream --u8_store_path`` trains on the
    CPU from JPEGs decoded once into the disk store (the JAX package's
    files), which a second run reopens."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import jpeg_fixtures
    from multimodal_edema_prediction_tpu_torch.cli.common import load_data
    args = train_teacher.build_parser().parse_args(
        ["--synthetic_stays", "40", "--n_variables", "34"])
    from multimodal_edema_prediction_tpu_torch.config import DataConfig
    ids = np.unique(load_data(args, DataConfig())[2].anchor["image_ids"])
    jpeg_fixtures.write_jpegs(str(tmp_path / "jpegs"), ids, 40, 36)
    store = str(tmp_path / "store" / "u8")
    argv = ["--device", "cpu", "--vit_size", "tiny", "--synthetic_stays",
            "40", "--batch_size", "16", "--epochs", "1", "--limit_batches",
            "1", "--warmup_steps", "1", "--no_save_state",
            "--cxr_jpeg_root", str(tmp_path / "jpegs"), "--image_bank",
            "stream", "--u8_store_path", store, "--prefetch_depth", "1"]
    first = train_teacher.main(argv + ["--ckpt_dir", str(tmp_path / "a")])
    again = train_teacher.main(argv + ["--ckpt_dir", str(tmp_path / "b")])
    assert first.extras["image_tier"]["tier"] == "u8_store"
    assert os.path.exists(store + ".u8") and os.path.exists(
        store + ".meta.json")
    assert first.history == again.history
    assert np.isfinite(first.history[0]["train_total"])


class _Caught(Exception):
    pass


def _catch(monkeypatch, mod, name: str) -> dict:
    """Replace ``mod.name`` by a stand-in that records its arguments and
    stops the CLI."""
    seen = {}

    def fake(*a, **k):
        seen.update(k, args=a)
        raise _Caught

    monkeypatch.setattr(mod, name, fake)
    return seen


# cli/finetune_mimic's flags → where each given value lands in
# ``finetune_duett``'s arguments (dataset, DuETT config, train config,
# checkpoint directory), and the value it must have there
SUPERVISED_PORTED = {
    "--ssl_ckpt": (["x.msgpack"], lambda s: s["ssl_ckpt"], "x.msgpack"),
    "--synthetic_stays": (["70"], lambda s: len(s["args"][0].labels), 70),
    "--n_variables": (["5"], lambda s: s["args"][1].n_variables, 5),
    "--n_timesteps": (["12"], lambda s: (s["args"][1].n_timesteps,
                                         s["args"][0].n_timesteps),
                      (12, 12)),
    "--d_embedding": (["6"], lambda s: s["args"][1].d_embedding, 6),
    "--n_duett_layers": (["3"], lambda s: s["args"][1].n_layers, 3),
    "--epochs": (["4"], lambda s: s["args"][2].epochs, 4),
    "--patience": (["2"], lambda s: s["args"][2].patience, 2),
    "--batch_size": (["8"], lambda s: s["args"][2].batch_size, 8),
    "--lr": (["0.5"], lambda s: s["args"][2].optim.lr, 0.5),
    "--weight_decay": (["0.25"], lambda s: s["args"][2].optim.weight_decay,
                       0.25),
    "--warmup_steps": (["7"], lambda s: s["args"][2].optim.warmup_steps, 7),
    "--seeds": (["4", "5"], lambda s: s["seeds"], (4, 5)),
    "--top_k": (["3"], lambda s: s["top_k"], 3),
    "--mixed_precision": (["bf16"], lambda s: s["args"][2].dtype,
                          "bfloat16"),
    "--ckpt_dir": (["/r/ft"], lambda s: s["args"][3], "/r/ft"),
}


@pytest.mark.parametrize("flag", sorted(SUPERVISED_PORTED))
def test_finetune_flags_reach_the_loop(flag, monkeypatch):
    vals, got, want = SUPERVISED_PORTED[flag]
    seen = _catch(monkeypatch, finetune_mimic, "finetune_duett")
    with pytest.raises(_Caught):
        finetune_mimic.main(["--device", "cpu", "--synthetic_stays", "40",
                             flag] + vals)
    assert got(seen) == want, flag
    assert seen["device"] == "cpu"


# cli/train_physionet's flags → where each lands: the SSL run's arguments
# (``ssl``) or the fine-tuning's (``ft``)
PHYSIONET_PORTED = {
    "--n_patients": (["30"], lambda ssl, ft: ssl["args"][0].grid.shape[0],
                     30),
    "--n_timesteps": (["12"], lambda ssl, ft: (ssl["args"][1].n_timesteps,
                                               ft["args"][0].n_timesteps),
                      (12, 12)),
    "--pretrain_epochs": (["3"], lambda ssl, ft: ssl["args"][2].epochs, 3),
    "--finetune_epochs": (["4"], lambda ssl, ft: ft["args"][2].epochs, 4),
    "--batch_size": (["8"], lambda ssl, ft: (ssl["args"][2].batch_size,
                                             ft["args"][2].batch_size),
                     (8, 8)),
    "--seeds": (["6"], lambda ssl, ft: ft["seeds"], (6,)),
    "--top_k": (["2"], lambda ssl, ft: ft["top_k"], 2),
    "--ckpt_dir": (["/r/p"], lambda ssl, ft: (ssl["args"][3],
                                              ft["args"][3]),
                   ("/r/p/ssl", "/r/p/finetune")),
    "--d_embedding": (["6"], lambda ssl, ft: ssl["args"][1].d_embedding, 6),
}


@pytest.mark.parametrize("flag", sorted(PHYSIONET_PORTED))
def test_physionet_flags_reach_the_loops(flag, monkeypatch):
    vals, got, want = PHYSIONET_PORTED[flag]
    ssl = {}

    class Result:
        best_path = "ssl.msgpack"

    def fake_ssl(*a, **k):
        ssl.update(k, args=a)
        return Result()

    monkeypatch.setattr(train_physionet, "train_ssl", fake_ssl)
    seen = _catch(monkeypatch, train_physionet, "finetune_duett")
    with pytest.raises(_Caught):
        train_physionet.main(["--device", "cpu", "--n_patients", "20", flag]
                             + vals)
    assert got(ssl, seen) == want, flag
    assert seen["ssl_ckpt"] == "ssl.msgpack"
    assert ssl["device"] == seen["device"] == "cpu"


def test_physionet_data_dir_reaches_the_raw_loader(tmp_path):
    with pytest.raises(FileNotFoundError, match="no P12 records"):
        train_physionet.main(["--device", "cpu", "--data_dir",
                              str(tmp_path)])


def test_finetune_data_dir_reaches_the_ingest(tmp_path):
    with pytest.raises(FileNotFoundError, match="cohort.npz"):
        finetune_mimic.main(["--device", "cpu", "--data_dir",
                             str(tmp_path)])


# cli/predict's flags → where each given value lands: the split's
# evaluation (``evaluate_dual_pathology``'s arguments), its data, or the
# feature source ``make_sources`` returns
PREDICT_PORTED = {
    "--split": (["val"], lambda s: s["args"][3], "val"),
    "--batch_size": (["8"], lambda s: s["args"][4], 8),
    "--synthetic_stays": (["50"], lambda s: len(s["args"][2].grid), 50),
    "--cxr_feature_cache": (["hbm"], lambda s: s["sources"][1] is not None,
                            True),
}


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from multimodal_edema_prediction_tpu_torch.config import TeacherConfig
    from multimodal_edema_prediction_tpu_torch.models.teacher import \
        init_teacher
    from multimodal_edema_prediction_tpu_torch.train.checkpoint import \
        save_checkpoint
    from torch_port_util import tiny_teacher_cfg
    cfg = TeacherConfig.from_dict(tiny_teacher_cfg().to_dict())
    path = str(tmp_path_factory.mktemp("predict") / "teacher.msgpack")
    save_checkpoint(path, init_teacher(cfg, 0), 1, 0.5,
                    config={"model": cfg.to_dict()})
    return path


@pytest.mark.parametrize("flag", sorted(PREDICT_PORTED))
def test_predict_flags_reach_the_eval(flag, tiny_ckpt, monkeypatch):
    vals, got, want = PREDICT_PORTED[flag]
    seen = _catch(monkeypatch, predict, "evaluate_dual_pathology")
    make_sources = predict.make_sources

    def recording(*a, **k):
        seen["sources"] = make_sources(*a, **k)
        return seen["sources"]

    monkeypatch.setattr(predict, "make_sources", recording)
    with pytest.raises(_Caught):
        predict.main(["--ckpt", tiny_ckpt, "--device", "cpu", flag] + vals)
    assert got(seen) == want, flag


def test_predict_writes_its_npz_where_out_says(tiny_ckpt, tmp_path):
    out = str(tmp_path / "sub" / "p.npz")
    predict.main(["--ckpt", tiny_ckpt, "--device", "cpu",
                  "--synthetic_stays", "40", "--out", out])
    with np.load(out) as z:
        assert "fusion_logits" in z.files
