"""The trajectory encoder and its probe in the port
(``models/trajectory.py``, ``analysis/train_trajectory_probe.py``) against
the JAX package's, on the CPU, with the JAX weights carried across by
``convert.load_flax``.

Tolerances: ``time_since_last_observation`` equal; the encoder's tokens
and the probe's logits within 1e-5, its gradients within 1e-4 of each
leaf's max abs floored at 1e-3 of the largest gradient's (the repo's
module and step bounds); one AdamW update on a
cosine schedule within 1e-5; a 2-epoch ``train_probe`` within 5e-3
relative (the loops' bound), started from JAX's initial parameters with
dropout 0 on both sides (flax folds a hash of each leaf's path into its
key and takes a QR for ``orthogonal``, so its draws cannot be redone in
torch: ``init_probe`` is replaced from the test, and each package's
``TrajectoryPathologyProbe`` patched to ``dropout=0.0``; nothing in the
JAX package changes). The port's checkpoint reads with
``flax.serialization.msgpack_restore`` into JAX's tree.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from analysis_port_util import _one_thread  # noqa: F401
from analysis_port_util import assert_report_close, flags
from multimodal_edema_prediction_tpu.analysis import \
    train_trajectory_probe as JP
from multimodal_edema_prediction_tpu.models import trajectory as JT
from multimodal_edema_prediction_tpu.ops.losses import \
    masked_per_label_bce as jbce
from multimodal_edema_prediction_tpu_torch.analysis import \
    train_trajectory_probe as P
from multimodal_edema_prediction_tpu_torch.convert import load_flax
from multimodal_edema_prediction_tpu_torch.models import trajectory as T
from multimodal_edema_prediction_tpu_torch.ops.losses import \
    masked_per_label_bce as tbce
from multimodal_edema_prediction_tpu_torch.train.checkpoint import \
    msgpack_restore
from torch_port_util import perturb

V, TT, K, D = 5, 24, 7, 32
# the attention keys' biases: their gradient is exactly 0 (a softmax does
# not see one shift of every logit of a row), so Adam moves them by ±lr
# after the sign of float32 rounding noise, in either package, and the
# logits do not depend on them; the parameter comparisons leave them out
KEY_BIASES = ("cross.k.bias", "self.k.bias")


def _windows(B, seed=0):
    """[B, 24, 2V] windows: N(0, 1) values, counts 0 (70%) to 3, a few
    negative (the event mask; the encoder clamps them)."""
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(B, TT, V))
    counts = np.where(rng.random((B, TT, V)) < 0.7, 0,
                      rng.integers(-1, 4, (B, TT, V)))
    counts[0, :, 0] = 0                  # a variable never observed
    return np.concatenate([values, counts], -1).astype(np.float32)


def _jax_probe(x, seed=0, dropout=0.1):
    m = JP.TrajectoryPathologyProbe(V, TT, K, D, dropout=dropout)
    params = perturb(m.init(jax.random.key(seed), jnp.asarray(x))["params"],
                     seed)
    return m, params


def _port_probe(params, dropout=0.1):
    return load_flax(P.TrajectoryPathologyProbe(V, TT, K, D, dropout=dropout),
                     params)


def test_time_since_last_observation_equals_jax():
    obs = np.random.default_rng(0).random((3, TT, V)) < 0.3
    np.testing.assert_array_equal(
        T.time_since_last_observation(torch.from_numpy(obs)).numpy(),
        np.asarray(JT.time_since_last_observation(jnp.asarray(obs))))


def test_encoder_and_probe_match_jax():
    """Tokens and padding mask of the encoder, the probe's logits (≤1e-5)
    and every parameter's gradient of the masked BCE (≤1e-4 of the leaf's
    max abs)."""
    x = _windows(6)
    m, params = _jax_probe(x)
    enc = JT.LocalTrajectoryEncoder(V, TT, D)
    jt, jpad = jax.jit(lambda p, x: enc.apply(
        {"params": p}, x, return_padding_mask=True))(params["encoder"],
                                                     jnp.asarray(x))
    model = _port_probe(params)
    pt, ppad = model.encoder(torch.from_numpy(x), return_padding_mask=True)
    np.testing.assert_array_equal(ppad.numpy(), np.asarray(jpad))
    assert ppad[0, :3].all() and not ppad.all()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(jt),
                               rtol=0, atol=1e-5)

    rng = np.random.default_rng(1)
    y = (rng.random((6, K)) < 0.4).astype(np.float32)
    mask = (rng.random((6, K)) < 0.8).astype(np.float32)

    def jloss(p):
        return jbce(m.apply({"params": p}, jnp.asarray(x)), y, mask).sum()

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    logits = model(torch.from_numpy(x))
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(jax.jit(lambda p: m.apply({"params": p}, jnp.asarray(x)))(
            params)), rtol=0, atol=1e-5)
    tl = tbce(logits, torch.from_numpy(y), torch.from_numpy(mask)).sum()
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    want = load_flax(P.TrajectoryPathologyProbe(V, TT, K, D),
                     jax.tree.map(np.asarray, jg)).state_dict()
    # each leaf's max abs floored at 1e-3 of the largest gradient
    # (tests/test_torch_modes_step.py): the keys' bias has a gradient of
    # exactly 0 (a softmax does not see a shift of every logit), which
    # float32 reads as ~1e-9 in both packages
    top = max(float(v.abs().max()) for v in want.values())
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        scale = max(float(np.abs(want[name].numpy()).max()), 1e-3 * top)
        assert np.abs(g - want[name].numpy()).max() <= 1e-4 * scale, name


def test_one_adamw_step_matches_optax():
    """optax ``adamw(cosine_decay_schedule(1e-3, 12), weight_decay=1e-4)``
    (the CLI's rate) against ``MultiGroupAdamW.one_group`` with
    ``cosine_decay``: one update, parameters within 1e-5."""
    x = _windows(6, 2)
    m, params = _jax_probe(x, 2, dropout=0.0)
    y = (np.random.default_rng(3).random((6, K)) < 0.4).astype(np.float32)
    mask = np.ones((6, K), np.float32)
    tx = optax.adamw(optax.cosine_decay_schedule(1e-3, 12),
                     weight_decay=1e-4)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    g = jax.jit(jax.grad(lambda p: jbce(
        m.apply({"params": p}, jnp.asarray(x)), y, mask).sum()))(jp)
    u, state = tx.update(g, state, jp)
    jp = optax.apply_updates(jp, u)
    model = _port_probe(params, dropout=0.0)
    opt = P.MultiGroupAdamW.one_group(model, P.cosine_decay(1e-3, 12),
                                      weight_decay=1e-4)
    P.train_step(model, opt, 0, torch.from_numpy(x), torch.from_numpy(y),
                 torch.from_numpy(mask), None)
    want = load_flax(P.TrajectoryPathologyProbe(V, TT, K, D),
                     jax.tree.map(np.asarray, jp)).state_dict()
    for name, p in model.state_dict().items():
        if name in KEY_BIASES:
            continue
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def _jax_init_probe(n_vars, n_timesteps, n_pathologies, d_model, seed, x0,
                    device="cpu"):
    """``init_probe`` from JAX's own initial parameters for the same
    arguments (what ``train_probe`` initializes with ``model.init``)."""
    variables = JP.TrajectoryPathologyProbe(
        n_vars, n_timesteps, n_pathologies, d_model).init(
        jax.random.key(seed), jnp.asarray(x0))
    return load_flax(P.TrajectoryPathologyProbe(
        n_vars, n_timesteps, n_pathologies, d_model),
        jax.tree.map(np.asarray, variables["params"])).to(device)


def _no_dropout(monkeypatch):
    monkeypatch.setattr(JP, "TrajectoryPathologyProbe", functools.partial(
        JP.TrajectoryPathologyProbe, dropout=0.0))
    monkeypatch.setattr(P, "TrajectoryPathologyProbe", functools.partial(
        P.TrajectoryPathologyProbe, dropout=0.0))


def test_train_probe_matches_jax(monkeypatch):
    """Two epochs of ``train_probe`` from JAX's initial parameters with
    dropout 0: the validation and test macro AUROCs and every per-label
    metric within 5e-3 relative, the best parameters within 5e-3 of each
    leaf's max abs."""
    from multimodal_edema_prediction_tpu.analysis import common as JC
    from multimodal_edema_prediction_tpu_torch.analysis import common as C
    _no_dropout(monkeypatch)
    monkeypatch.setattr(P, "init_probe", _jax_init_probe)
    import argparse

    def data(pkg):
        p = argparse.ArgumentParser()
        pkg.add_analysis_flags(p, needs_ckpt=False)
        args = p.parse_args(flags(None, "-"))
        _, meta, ds, dcfg = pkg.load_analysis_data(args)
        return ds, dcfg.pathology_labels, meta.n_variables

    jds, labels, nv = data(JC)
    want = JP.train_probe(jds, labels, nv, d_model=16, epochs=2,
                          batch_size=16, seed=3)
    got = P.train_probe(data(C)[0], labels, nv, d_model=16, epochs=2,
                        batch_size=16, seed=3, device="cpu")
    jparams, pparams = want.pop("best_params"), got.pop("best_params")
    assert_report_close(got, want, 5e-3)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(pparams))
    assert len(flat_j) == len(flat_p)
    for path, a in flat_j:
        b = flat_p[path]
        assert b.shape == a.shape, path
        if jax.tree_util.keystr(path) in ("['cross']['k']['bias']",
                                          "['self']['k']['bias']"):
            continue
        scale = max(float(np.abs(a).max()), 1e-12)
        assert np.abs(b - a).max() <= 5e-3 * scale, path


def test_main_writes_jax_files_and_a_flax_checkpoint(tmp_path, capsys):
    """The CLI end to end at ``--n_variables 8 --d_model 32``: JAX's four
    files; the checkpoint restores with flax into JAX's parameter tree (the
    same keys and shapes) and loads back into the port's probe with the
    logged validation AUROC."""
    extra = ["--n_variables", "8", "--d_model", "32", "--epochs", "2"]
    got = P.main(flags(None, tmp_path / "p", extra + ["--device", "cpu"]))
    out = capsys.readouterr().out
    assert "val macro AUROC" in out and "label_edema" in out
    JP.main(flags(None, tmp_path / "j", extra))
    assert sorted(os.listdir(tmp_path / "p")) == \
        sorted(os.listdir(tmp_path / "j"))
    path = tmp_path / "p" / "trajectory_probe_best.msgpack"
    with open(path, "rb") as f:
        raw = f.read()
    restored = serialization.msgpack_restore(raw)
    jtree = JP.TrajectoryPathologyProbe(8, 24, 7, 32).init(
        jax.random.key(0), jnp.zeros((2, 24, 16)))["params"]
    shapes = jax.tree.map(lambda a: tuple(a.shape), restored)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape),
                                  jax.tree.map(np.asarray, jtree))
    model = load_flax(P.TrajectoryPathologyProbe(8, 24, 7, 32),
                      msgpack_restore(raw))
    assert all(torch.isfinite(p).all() for p in model.parameters())
    with open(str(path) + ".config.json") as f:
        cfg = json.load(f)
    assert cfg["val_macro_auroc"] == got["val_macro_auroc"]
    assert np.isfinite(got["test_macro_auroc"])


def test_probe_refuses_to_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main(flags(None, tmp_path))
