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

Training on the card repeats bitwise, so a resumed run equals an
uninterrupted one (``fit/checkpoint.py``): cuDNN takes deterministic
algorithms and no benchmark-picked ones, and cuBLAS gets a fixed
workspace (``CUBLAS_WORKSPACE_CONFIG``, read when its first handle is
made, so it is set here unless the caller set it). The port's own ops
avoid atomics in their backward (``nn/conv.py:upsample_bilinear_2x``).
"""
import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False

__version__ = "0.1.0"

from awesome_tpu_torch.device import resolve_device  # noqa: E402,F401
