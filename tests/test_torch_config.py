"""The port's copy of ``config.py`` equals the JAX package's: the same
classes with the same fields and defaults, the same dicts, and sidecars that
round-trip between the two."""
import dataclasses

import pytest

import multimodal_edema_prediction_tpu.config as J
import multimodal_edema_prediction_tpu_torch.config as P


def _config_classes(mod):
    return sorted(n for n, c in vars(mod).items()
                  if isinstance(c, type) and dataclasses.is_dataclass(c)
                  and c.__module__ == mod.__name__)


def test_same_classes_and_constants():
    assert _config_classes(P) == _config_classes(J)
    assert P.DEFAULT_PATHOLOGY_LABELS == J.DEFAULT_PATHOLOGY_LABELS
    assert P.TAG_EXCLUDE == J.TAG_EXCLUDE


@pytest.mark.parametrize("name", _config_classes(J))
def test_defaults_and_to_dict(name):
    jc, pc = getattr(J, name)(), getattr(P, name)()
    assert [f.name for f in dataclasses.fields(pc)] == \
        [f.name for f in dataclasses.fields(jc)]
    assert pc.to_dict() == jc.to_dict()
    assert pc.diff_tag() == jc.diff_tag()


def test_from_dict_round_trip_between_packages():
    jc = J.TeacherConfig(
        vit=J.ViTConfig(image_size=224, n_layers=3),
        duett=J.DuettConfig(n_variables=9, d_embedding=16),
        perceiver=J.PerceiverConfig(d_latent=64, use_flash=True,
                                    correction_dropout=0.3),
        freeze_duett=True)
    pc = P.TeacherConfig.from_dict(jc.to_dict())
    assert pc.to_dict() == jc.to_dict()
    assert pc == P.TeacherConfig.from_dict(pc.to_dict())
    assert J.TeacherConfig.from_dict(pc.to_dict()) == jc
    td = J.TrainConfig(batch_size=8, optim=J.OptimConfig(lr=1e-3)).to_dict()
    assert P.TrainConfig.from_dict(td).to_dict() == td
    dd = J.DataConfig(count_clip=9).to_dict()
    assert P.DataConfig.from_dict(dd) == P.DataConfig(count_clip=9)
    assert isinstance(P.DataConfig.from_dict(dd).pathology_labels, tuple)


def test_validation_is_copied():
    with pytest.raises(ValueError):
        P.DataConfig(label_col="label_cardiomegaly")
    with pytest.raises(ValueError):
        P.TeacherConfig(vit=P.ViTConfig(quant="int8"), freeze_cxr=False)
