"""drn_tpu_torch: the PyTorch/CUDA port of drn_tpu (DRN temporal grounding).

The port imports torch and numpy, never JAX nor anything of `drn_tpu`. Its
kernels are hand-written CUDA for Hopper (ops/cuda/); on a CPU tensor each
kernel wrapper calls its plain PyTorch version instead.

Importing the package turns TF32 off for cuDNN convolutions and CUDA
matmuls (`torch.backends.cudnn.allow_tf32`, `torch.backends.cuda.matmul.
allow_tf32`): an fp32 product of the port, the plain versions the kernels
are held against included, is then computed in full fp32. It also keeps
cuBLAS from reducing a split bf16 product in bf16
(`allow_bf16_reduced_precision_reduction`): the backward's weight
gradients, products over all B·T rows, accumulate in fp32 as the JAX
package's do.
"""

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
