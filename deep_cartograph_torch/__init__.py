"""deep_cartograph_torch: the PyTorch/CUDA port of the JAX package.

It mirrors the JAX package's module paths and public names. Hot kernels are
hand-written CUDA C++ for Hopper (`ops/csrc/`); everything else is plain
PyTorch. Entry points run on the CUDA device unless the caller passes
`device="cpu"`.
"""

__version__ = "0.1.0"

import torch as _torch

# The JAX package forces full f32 matmul accuracy (its `highest` default
# precision): absolute coordinates and TICA covariances lose ~1e-3 to
# reduced-precision inputs, which breaks the 1e-4 projection contract.
# TF32 keeps about three decimal digits, so it is off for matmuls and cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
