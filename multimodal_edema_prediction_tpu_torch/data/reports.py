"""Radiology-report sectioning + EXT-ILS lesion catalog (L0, cxr_db.ipynb).

- :func:`extract_sections` — the reference's priority rule for pulling text
  out of a MIMIC-CXR report (cxr_db cell 15): FINDINGS body first, else
  IMPRESSION, else the last paragraph, else the sentinel string.
- :func:`build_report_table` — walk the ``reports/p10..p19/<subject>/
  <study>.txt`` layout into a columnar table (cell 15's
  ``build_report_dataframe``).
- :func:`build_lesion_catalog` — flatten the EXT-ILS
  ``mimic_ils_instruction_answer.json`` into per-study rows with
  ``label_<lesion>`` / ``mask_<lesion>`` / ``loc_<lesion>`` columns over the
  7 CheXpert target lesions (cells 10-12), including the reference's
  post-processing: grounded locations joined with ", ", missing
  cardiomegaly location defaulted to "heart", ``dicom_id`` derived from the
  image filename and ``image_path`` prefixed with ``files/``.

The port's copy of ``multimodal_edema_prediction_tpu/data/reports.py``.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence

NO_TEXT = "No text extracted"

TARGET_LESIONS = ("cardiomegaly", "pneumonia", "atelectasis", "opacity",
                  "consolidation", "edema", "effusion")

_FINDINGS_RE = re.compile(r"FINDINGS:(.*?)((?:IMPRESSION:)|$)",
                          re.DOTALL | re.IGNORECASE)
_IMPRESSION_RE = re.compile(r"IMPRESSION:(.*)", re.DOTALL | re.IGNORECASE)


def extract_sections(text: Optional[str]) -> str:
    """FINDINGS → IMPRESSION → last paragraph → sentinel (cxr_db cell 15)."""
    if not text or not isinstance(text, str):
        return NO_TEXT
    m = _FINDINGS_RE.search(text)
    if m:
        body = m.group(1).strip()
        if body:
            return body
    m = _IMPRESSION_RE.search(text)
    if m:
        body = m.group(1).strip()
        if body:
            return body
    paragraphs = [p.strip() for p in re.split(r"\n\s*\n", text.strip())
                  if p.strip()]
    if paragraphs:
        return paragraphs[-1]
    return NO_TEXT


def build_report_table(base_path: str) -> Dict[str, List[str]]:
    """reports/p10..p19/<subject_id>/<study_id>.txt → columnar table
    (subject_id, study_id, report, txt_path)."""
    rows: Dict[str, List[str]] = {"subject_id": [], "study_id": [],
                                  "report": [], "txt_path": []}
    for i in range(10, 20):
        current = os.path.join(base_path, f"p{i}")
        if not os.path.isdir(current):
            continue
        for root, _, files in sorted(os.walk(current)):
            for fn in sorted(files):
                if not fn.endswith(".txt"):
                    continue
                path = os.path.join(root, fn)
                with open(path, encoding="utf-8") as f:
                    content = f.read()
                rows["subject_id"].append(os.path.basename(root))
                rows["study_id"].append(os.path.splitext(fn)[0])
                rows["report"].append(extract_sections(content))
                rows["txt_path"].append(path)
    return rows


def build_lesion_catalog(raw: dict, lesion_data_path: str = "",
                         splits: Sequence[str] = ("train", "val", "test")
                         ) -> List[dict]:
    """EXT-ILS instruction-answer JSON → per-study lesion rows
    (cxr_db cells 10-12)."""
    rows: List[dict] = []
    for split in splits:
        if split not in raw:
            continue
        for study_id, info in raw[split].items():
            entry = {"study_id": study_id,
                     "subject_id": info.get("subject_id"),
                     "image_path": info.get("image_path")}
            for lesion in TARGET_LESIONS:
                entry[f"label_{lesion}"] = 0
                entry[f"mask_{lesion}"] = None
                entry[f"loc_{lesion}"] = []
            pairs = info.get("instruction_answer_pairs", {})
            for pair in pairs.get("positive_pairs", []):
                lesion = pair.get("target")
                if lesion in TARGET_LESIONS:
                    entry[f"label_{lesion}"] = 1
                    entry[f"mask_{lesion}"] = pair.get("seg_mask_path")
                    entry[f"loc_{lesion}"] = pair.get("grounded_location",
                                                      [])
            rows.append(entry)

    for entry in rows:                               # cell 12 post-processing
        for lesion in TARGET_LESIONS:
            mask = entry[f"mask_{lesion}"]
            if mask is not None and lesion_data_path:
                entry[f"mask_{lesion}"] = os.path.join(
                    lesion_data_path, "lesion_mask", mask)
            loc = entry[f"loc_{lesion}"]
            entry[f"loc_{lesion}"] = ", ".join(loc) \
                if isinstance(loc, list) and loc else None
        if entry["label_cardiomegaly"] == 1 \
                and entry["loc_cardiomegaly"] is None:
            entry["loc_cardiomegaly"] = "heart"     # fixed anatomical site
        img = entry.get("image_path") or ""
        entry["dicom_id"] = os.path.basename(img).replace(".jpg", "")
        entry["image_path"] = f"files/{img}" if img else img
    return rows
