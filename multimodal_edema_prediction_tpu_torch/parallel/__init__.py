"""Data parallelism over processes (``multihost``: ``torch.distributed``,
per-process batch slices, the global batch's statistics and draws, host
gathers) and the mesh checks and tensor-parallel rules (``mesh``): the
port's counterpart of ``multimodal_edema_prediction_tpu/parallel/``."""
