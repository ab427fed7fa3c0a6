"""awesome_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of
``awesome_tpu``.

Module for module it mirrors the JAX package (``core``, ``nn``,
``measures``, ``fit``, ``ops``) so a reader can find each counterpart.
Parameters are nested dicts of tensors, like the JAX param trees. Every
Pallas kernel of the JAX package has a hand-written CUDA counterpart: the
fused flagship loss+grad (``ops/csrc/flagship.cu``) and the ICNN forward
and backward (``ops/csrc/icnn.cu``).

Entry points that create tensors take ``device=`` and default to
``"cuda"``; without a GPU they raise unless the caller passes
``device="cpu"``. Float32 matmuls and convolutions run in full FP32:
TF32 is switched off here for the whole process.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from awesome_tpu_torch.device import resolve_device  # noqa: E402,F401
