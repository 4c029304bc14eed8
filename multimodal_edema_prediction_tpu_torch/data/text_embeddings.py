"""Radiology-report text embeddings (legacy multimodal path, L0).

Re-implements the PubMedBERT report-embedding pipeline of
``[subject_data]time_series_text_preprocess.ipynb`` cells 128-148:

- :func:`clean_radiology_report` (cell 143): whitespace collapse + strip
  of separator runs (``--``, ``==``, ``++``, ``##``, ``**``).
- :func:`embed_reports` (cells 146-147): tokenize to 128 tokens, encode
  with a HF ``AutoModel`` (the reference uses
  ``NeuML/pubmedbert-base-embeddings``, a sentence-embedding model →
  attention-masked MEAN pooling; ``pooling="cls"`` also offered), return
  ``[N, d]`` numpy. The encoder is injected, so the pipeline tests against
  a locally built tiny BERT and runs offline; pass the real PubMedBERT
  model where weights are available.
- :func:`join_text_flag` (cell 148): per-(stay, slot) ``text_flag`` column
  marking rows with an embedded report.

The produced embeddings are the per-slot text modality the legacy
``main_train.py`` path consumed (dead in the reference tree — SURVEY §2.3);
they are exposed here as a first-class L0 artifact.

The port's copy of ``multimodal_edema_prediction_tpu/data/text_embeddings.py``.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np


def clean_radiology_report(text) -> str:
    """Cell 143: collapse whitespace, drop 2+ runs of ``-=+#*``."""
    if not isinstance(text, str):
        return ""
    text = re.sub(r"\s+", " ", text)
    text = re.sub(r"[-=+#*]{2,}", " ", text)
    return text.strip()


def embed_reports(texts: Sequence[str], tokenizer, model,
                  batch_size: int = 32, max_tokens: int = 128,
                  pooling: str = "mean", device: str = "cuda") -> np.ndarray:
    """Texts → ``[N, d]`` embeddings with a torch HF encoder (cells 146-147).

    ``pooling="mean"``: attention-masked mean of the last hidden state (the
    sentence-embedding convention of the reference's model);
    ``"cls"``: first token. The encoder runs on ``device`` (moved there),
    the card unless the caller asks for the CPU.
    """
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("embed_reports: no CUDA device; pass "
                           "device='cpu' to run the encoder on the CPU")
    model = model.to(dev)
    model.eval()
    outs: List[np.ndarray] = []
    cleaned = [clean_radiology_report(t) for t in texts]
    with torch.no_grad():
        for i in range(0, len(cleaned), batch_size):
            batch = cleaned[i:i + batch_size]
            enc = tokenizer(batch, return_tensors="pt",
                            max_length=max_tokens, truncation=True,
                            padding="max_length")
            ids = enc["input_ids"].to(dev)
            mask = enc["attention_mask"].to(dev)
            hidden = model(input_ids=ids, attention_mask=mask
                           ).last_hidden_state            # [B, T, d]
            if pooling == "mean":
                m = mask.unsqueeze(-1).float()
                emb = (hidden * m).sum(1) / m.sum(1).clamp(min=1.0)
            elif pooling == "cls":
                emb = hidden[:, 0]
            else:
                raise ValueError(pooling)
            outs.append(emb.float().cpu().numpy())
    return np.concatenate(outs, 0) if outs else np.zeros((0, 0), np.float32)


def join_text_flag(stay_ids: np.ndarray, slot_idx: np.ndarray,
                   embedded: Sequence[Tuple[int, int]]
                   ) -> np.ndarray:
    """Cell 148: ``text_flag=1`` on rows whose (stay, slot) has an
    embedding."""
    have = set((int(s), int(k)) for s, k in embedded)
    return np.asarray([1.0 if (int(s), int(k)) in have else 0.0
                       for s, k in zip(stay_ids, slot_idx)], np.float32)
