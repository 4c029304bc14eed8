"""The analysis suite: the shared machinery (``common.py``), the UMAP and
t-SNE of the figure suite (``umap_impl.py``, ``tsne.py``) and every script
of the JAX package's ``analysis/``, each runnable as ``python -m
multimodal_edema_prediction_tpu_torch.analysis.<name>``."""
