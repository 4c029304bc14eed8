"""The analysis suite's shared machinery (``common.py``), as far as the
inference CLI (``cli/predict.py``) needs it; the analysis scripts are
ROADMAP P19."""
