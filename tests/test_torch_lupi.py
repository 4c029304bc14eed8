"""The port's LUPI distillation losses (``ops/lupi_losses.py``) against the
JAX package's, on the CPU: values and gradients (``torch.autograd``
against ``jax.grad``) within 1e-6 at float32, on seeded numpy inputs with
NaN labels, the count-0 branches (no valid row, an empty subtype mask) and
3-D fused features. The teacher-side inputs get no gradient in either
package (``stop_gradient`` / ``detach``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_edema_prediction_tpu.ops import lupi_losses as J
from multimodal_edema_prediction_tpu_torch.ops import lupi_losses as Pt

TOL = 1e-6
B, K, D, N = 6, 4, 5, 3


def _inputs(case):
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    y = rng.random(B).astype(np.float32)
    y[[1, 4]] = np.nan
    if case == "all_nan":
        y[:] = np.nan
    mask = (rng.random(B) > 0.4).astype(np.float32)
    if case == "all_nan":
        mask[:] = 0.0
    probs = rng.random((B, K)).astype(np.float32)
    fused = (f(B, N, D) if case != "flat" else f(B, D)) * 2.0
    return {"logit_priv": f(B), "logit_deploy": f(B), "soft_labels": y,
            "fused_priv": fused + f(*fused.shape), "fused_deploy": fused,
            "readout_priv": f(B, D) * 2.0, "readout_deploy": f(B, D),
            "subtype_logits_priv": f(B, K), "subtype_logits_deploy": f(B, K),
            "subtype_target_probs": probs / probs.sum(-1, keepdims=True),
            "subtype_mask": mask}


# function → (its arguments from the inputs, which are differentiated,
# extra keywords)
FUNCS = {
    "masked_soft_cross_entropy": (
        ("subtype_logits_deploy", "subtype_target_probs", "subtype_mask"),
        ("subtype_logits_deploy",), {}),
    "nan_masked_bce": (("logit_deploy", "soft_labels"), ("logit_deploy",),
                       {}),
    "_cos_l1_match": (("readout_deploy", "readout_priv"),
                      ("readout_deploy", "readout_priv"), {}),
    "covariance_regularization": (("readout_deploy",), ("readout_deploy",),
                                  {}),
    "binary_logit_kd": (("logit_priv", "logit_deploy", "valid"),
                        ("logit_priv", "logit_deploy"), {"T": 3.0}),
    "dual_stream_distillation_loss": (
        ("logit_priv", "logit_deploy", "soft_labels", "fused_priv",
         "fused_deploy", "readout_priv", "readout_deploy",
         "subtype_logits_priv", "subtype_logits_deploy",
         "subtype_target_probs", "subtype_mask"),
        ("logit_priv", "logit_deploy", "fused_priv", "fused_deploy",
         "readout_priv", "readout_deploy", "subtype_logits_priv",
         "subtype_logits_deploy"),
        {"cov_weight": 0.3, "subtype_weight": 0.7, "fd_weight": 0.5,
         "rd_weight": 2.0, "kd_weight": 1.5, "kd_T": 2.5}),
}


def _first(out):
    if isinstance(out, dict):
        return out["total"]
    return out[0] if isinstance(out, tuple) else out


def _flat(out):
    """Every value of an output (a scalar, a tuple or a dict) by name."""
    if isinstance(out, dict):
        return dict(out)
    if isinstance(out, tuple):
        return {str(i): v for i, v in enumerate(out)}
    return {"0": out}


@pytest.mark.parametrize("case", ["mixed", "all_nan", "flat"])
@pytest.mark.parametrize("name", sorted(FUNCS))
def test_value_and_gradient_match_jax(name, case):
    names, diff, kw = FUNCS[name]
    x = _inputs(case)
    x["valid"] = (~np.isnan(x["soft_labels"])).astype(np.float32)
    jfn, pfn = getattr(J, name), getattr(Pt, name)

    def jcall(*d):
        args = dict(zip(diff, d))
        return jfn(*[args.get(n, jnp.asarray(x[n])) for n in names], **kw)

    want = _flat(jcall(*[jnp.asarray(x[n]) for n in diff]))
    grads = jax.grad(lambda *d: _first(jcall(*d)),
                     argnums=tuple(range(len(diff))))(
        *[jnp.asarray(x[n]) for n in diff])

    leaves = {n: torch.tensor(x[n], requires_grad=n in diff) for n in names}
    out = pfn(*[leaves[n] for n in names], **kw)
    got = _flat(out)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(torch.as_tensor(got[k])
                                              .detach(), np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=TOL, atol=TOL, err_msg=k)
    _first(out).backward()
    for n, g in zip(diff, grads):
        pg = leaves[n].grad
        pg = np.zeros_like(x[n]) if pg is None else pg.numpy()
        np.testing.assert_allclose(pg, np.asarray(g), rtol=TOL, atol=TOL,
                                   err_msg=f"d/d{n}")
