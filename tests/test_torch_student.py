"""The port's student (``models/student.py::StudentModel``) against the JAX
package's: the same flax variables (perturbed, so BatchNorm statistics and
biases are not trivial) carried into the port by ``convert.load_flax``, the
same inputs from a seeded numpy Generator, float32, head dropout 0.

Tolerances: logits ≤1e-5 (absolute and relative), in eval mode and in train
mode (batch statistics), with the BatchNorm running statistics after the
train-mode forward ≤1e-5; the flax → torch → flax round trip of the
student's variables bit-equal.
"""
import jax
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.config import (DuettConfig as JDuett,
                                                    StudentConfig as JStudent)
from multimodal_edema_prediction_tpu.models.student import StudentModel as JS
from multimodal_edema_prediction_tpu_torch.config import StudentConfig
from multimodal_edema_prediction_tpu_torch.convert import (flax_to_state_dict,
                                                           load_flax, to_flax)
from multimodal_edema_prediction_tpu_torch.models.student import (
    StudentModel, init_student)
from torch_port_util import init_perturbed

B, T, V = 4, 24, 6


def _cfg(pool: str) -> JStudent:
    return JStudent(
        duett=JDuett(n_variables=V, n_timesteps=T, d_embedding=8, n_layers=2,
                     d_feedforward=16, d_hidden_mlp_embedding=8,
                     d_hidden_tab_encoder=8),
        pool=pool, head_hidden=16, head_dropout=0.0)


def _inputs(cfg: JStudent, seed: int = 0):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(B, T, V))
    counts = rng.integers(-1, 4, size=(B, T, V))
    mask = (rng.random((B, T, 1)) < 0.2)
    x_in = np.concatenate([values, counts, mask], -1).astype(np.float32)
    x_static = rng.normal(size=(B, cfg.duett.d_static)).astype(np.float32)
    times = np.tile(np.arange(1, T + 1, dtype=np.float32) / 24, (B, 1))
    return x_in, x_static, times


@pytest.fixture(scope="module", params=["mean", "rep_token"])
def student(request):
    jcfg = _cfg(request.param)
    inputs = _inputs(jcfg)
    params, stats = init_perturbed(JS(jcfg), *inputs)
    return jcfg, inputs, params, stats


@pytest.mark.parametrize("train", [False, True])
def test_student_matches_jax(student, train):
    jcfg, inputs, params, stats = student
    out = JS(jcfg).apply({"params": params, "batch_stats": stats}, *inputs,
                         train=train,
                         mutable=["batch_stats"] if train else False)
    want, new_stats = out if train else (out, None)
    model = load_flax(StudentModel(StudentConfig.from_dict(jcfg.to_dict())),
                      params, stats)
    got = model(*(torch.from_numpy(x) for x in inputs), train=train)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    if train:
        sd = model.state_dict()
        for k, v in flax_to_state_dict(
                {}, jax.tree.map(np.asarray,
                                 new_stats["batch_stats"])).items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_student_variables_round_trip_bit_equal(student):
    """flax → torch (``load_flax``) → flax (``to_flax``): every leaf of
    ``params`` and ``batch_stats`` comes back bit for bit, under flax's
    names (``duett``, ``head_in``, ``head_out``)."""
    jcfg, _, params, stats = student
    model = load_flax(StudentModel(StudentConfig.from_dict(jcfg.to_dict())),
                      params, stats)
    p2, s2 = to_flax(model)
    assert set(p2) == {"duett", "head_in", "head_out"}
    for want, got in ((params, p2), (stats, s2)):
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        other = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(other) == len(flat) > 0
        for path, leaf in flat:
            np.testing.assert_array_equal(other[path], leaf,
                                          err_msg=str(path))


def test_init_student_has_flax_shapes():
    """``init_student`` builds every leaf JAX's ``init`` builds, with its
    shape, and draws the head from the seed."""
    jcfg = _cfg("mean")
    variables = jax.jit(JS(jcfg).init)(jax.random.key(0), *_inputs(jcfg))
    want = flax_to_state_dict(jax.tree.map(np.asarray, variables["params"]),
                              jax.tree.map(np.asarray,
                                           variables["batch_stats"]))
    cfg = StudentConfig.from_dict(jcfg.to_dict())
    got = init_student(cfg, 0).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert not torch.equal(init_student(cfg, 1).head_in.weight,
                           got["head_in.weight"])


def test_student_refuses_an_unknown_pool():
    with pytest.raises(ValueError, match="unknown pool"):
        StudentModel(StudentConfig.from_dict(_cfg("max").to_dict()))
