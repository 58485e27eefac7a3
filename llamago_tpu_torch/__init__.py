"""llamago_tpu_torch — the PyTorch/CUDA port of llamago_tpu for one NVIDIA H100.

Module for module the counterpart of the JAX package `llamago_tpu`, which
stays the reference the port is tested against. Plain tensor code is
PyTorch; each Pallas kernel on the ported path is a CUDA C++ kernel for
Hopper (`csrc/`, built with nvcc for sm_90a at first use, ops/_build.py).

Entry points (`runtime.engine.Engine`, `server.api.JobServer`, `cli`, the
parameter builders in `checkpoint.params`) run on `cuda` unless the caller
passes `device="cpu"`; on the CPU every kernel wrapper takes its plain
PyTorch version.
"""

__version__ = "0.1.0"

from llamago_tpu_torch.config import GenerateConfig, ModelConfig  # noqa: F401
