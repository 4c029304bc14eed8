"""The analysis suite: the shared machinery (``common.py``) and the scripts
ported so far, each runnable as ``python -m
multimodal_edema_prediction_tpu_torch.analysis.<name>``; the rest of the
JAX package's ``analysis/`` is ROADMAP P19b."""
