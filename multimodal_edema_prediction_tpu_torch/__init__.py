"""PyTorch/CUDA port of ``multimodal_edema_prediction_tpu`` for NVIDIA Hopper.

The JAX package beside it stays the reference; this package imports
nothing of it (nor JAX), keeps its own copy of what it needs, and is held
against it by ``tests/test_torch_*.py``. Its kernels are written by hand in
CUDA C++ (``csrc/``) and built at first use (``ops/build.py``). Entry points
run on the card (``device="cuda"``) unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
