"""PyTorch/CUDA port of the MoDE diffusion policy, for one NVIDIA H100.

The JAX package ``mode_diffusion_policy_tpu`` is the reference; this package
mirrors its module names (``models/modedit.py``, ``models/agent.py``,
``serving.py`` ...) and imports nothing of it. Plain tensor code is PyTorch;
each Pallas kernel on the served path is a hand-written CUDA kernel under
``csrc/`` (built with ``nvcc`` at first use, loaded with ``ctypes``).

Entry points take ``device="cuda"`` by default and raise when CUDA is
missing unless the caller passes ``device="cpu"`` (tests do), in which case
every kernel wrapper runs its plain PyTorch version.
"""
from .utils.device import resolve_device

__all__ = ["resolve_device"]
