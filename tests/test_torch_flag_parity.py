"""Fault F3: every flag of the JAX package's CLIs parses in the port's.

The JAX parsers of ``cli/train_teacher``, ``cli/train_ssl``,
``cli/train_student``, ``cli/train_cxr_head`` and ``cli/serve`` are
collected by intercepting
``parse_args``, as ``tests/test_flag_parity.py:39-64`` collects the
reference's. Each of their
flags is either accepted by the port with the JAX default, or listed in
``WAIVERS`` with the ROADMAP item that ports it; a waived flag, when given
(with a value the JAX parser takes), raises ``NotImplementedError`` naming
that item right after parsing, before any data, model or device work.
``--eval_train_batches`` is ported: one CPU teacher run shows the
train-subset evaluation and its gap table. The teacher's P13 flags (the
other modes and LP mode) were waived until it was done; each now reaches the
configuration or the loop's arguments (``PORTED``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.cli import serve as jax_serve
from multimodal_edema_prediction_tpu.cli import train_cxr_head as jax_cxr_head
from multimodal_edema_prediction_tpu.cli import train_ssl as jax_ssl
from multimodal_edema_prediction_tpu.cli import train_student as jax_student
from multimodal_edema_prediction_tpu.cli import train_teacher as jax_teacher
from multimodal_edema_prediction_tpu_torch.cli import (serve,
                                                       train_cxr_head,
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
        "serve": (jax_serve, serve)}
# what a CLI needs before the flag under test (serve's --ckpt and the
# student's --teacher_ckpt are required)
REQUIRED = {"serve": ["--ckpt", "x.msgpack"],
            "train_student": ["--teacher_ckpt", "x.msgpack"]}
# ... and the port's training CLIs would otherwise default to the card
BASE = {cli: REQUIRED.get(cli, []) + ["--device", "cpu"] for cli in CLIS}

_LOGGING = {"--log_every": "P20", "--wandb_project": "P20",
            "--wandb_run_name": "P20", "--wandb_disabled": "P20"}
# JAX flag → the ROADMAP item that ports it
WAIVERS = {
    "train_teacher": {
        **_LOGGING,
        "--image_bank": "P15", "--hbm_image_budget_gb": "P15",
        "--u8_store_path": "P15", "--prefetch_depth": "P15",
        "--grad_diag_every": "P19", "--grad_diag_batches": "P19"},
    "train_ssl": dict(_LOGGING),
    "train_student": dict(_LOGGING),
    "train_cxr_head": {},
    "serve": {"--cxr_jpeg_root": "P17", "--data_parallel": "P17",
              "--aot_dir": "P17"},
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
}


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
    + [("train_teacher", f) for f in PORTED]))
def test_waived_flag_raises_naming_its_item(cli, flag):
    """A waived flag raises naming its item; a flag of ``PORTED`` (waived
    until its item was done) parses to the value given, which reaches the
    configs or the LP arguments, with ``--lp_only_correction`` (JAX sets
    LP mode's dropout and checkpoint only with it)."""
    jax_mod, port_mod = CLIS[cli]
    argv = _given(_actions(_parser(jax_mod))[flag], flag)
    # a valid JAX invocation
    _parser(jax_mod).parse_args(REQUIRED.get(cli, []) + argv)
    if flag in PORTED:
        from multimodal_edema_prediction_tpu_torch.cli.common import \
            configs_from_args
        from multimodal_edema_prediction_tpu_torch.config import ViTConfig
        args = port_mod.build_parser().parse_args(
            argv + ["--lp_only_correction"])
        dcfg, duett, train = configs_from_args(args)
        got = PORTED[flag]({
            "train": train, "lp": port_mod.lp_kwargs(args),
            "teacher": port_mod.teacher_config(args, dcfg, duett,
                                               ViTConfig())})
        want = True if len(argv) == 1 else type(got)(argv[1])
        assert got == want, (flag, got)
        return
    with pytest.raises(NotImplementedError,
                       match=f"{flag}.*ROADMAP {WAIVERS[cli][flag]}"):
        port_mod.main(BASE[cli] + argv)


@pytest.mark.parametrize("cli", ["train_teacher", "train_ssl"])
def test_accepted_flags_reach_the_configs(cli):
    """``--synthetic`` and ``--eval_train_batches`` as JAX takes them
    (``cli/common.py:25, :55, :105``); the teacher's ``--flash_block_b``
    (a TPU tuning knob) is parsed and ignored."""
    from multimodal_edema_prediction_tpu_torch.cli.common import \
        configs_from_args
    port_mod = CLIS[cli][1]
    argv = ["--synthetic", "--eval_train_batches", "3"]
    if cli == "train_teacher":
        argv += ["--flash_block_b", "4", "--no_save_state"]
    args = port_mod.build_parser().parse_args(argv)
    assert args.synthetic is True
    assert configs_from_args(args)[2].eval_train_batches == 3
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
