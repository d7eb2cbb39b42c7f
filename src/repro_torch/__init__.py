"""PyTorch/CUDA port of the QForce-RL engine.

``repro_torch`` mirrors the JAX reference package ``repro`` module for
module (``repro_torch.core.qmatmul`` answers to ``repro.core.qmatmul``)
and keeps its layouts at every public function: activations NHWC, conv
weights HWIO, linear ``w`` as ``[d_in, d_out]``, and a ``QTensor`` as an
int8 payload plus an fp32 scale plus ``bits``.  The Pallas kernels of
the reference become CUDA C++ kernels for Hopper (``sm_90a``) under
``repro_torch.kernels``; everything XLA lowered is plain PyTorch.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve_device`).

fp32 must mean fp32 on the card: cuDNN convolutions default to TF32, so
importing the package turns that off, and refuses to load if float32
matmuls were switched to TF32 by someone else.  Training on the card is
reproducible, as the reference's is: cuDNN is held to deterministic
algorithms (its default picks may sum a convolution's weight gradient
in a run-dependent order).
"""
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
if torch.backends.cuda.matmul.allow_tf32:
    raise RuntimeError(
        "torch.backends.cuda.matmul.allow_tf32 is True: fp32 products "
        "would run in TF32 and the port would no longer compute fp32")
