"""PyTorch/CUDA port of the LiDAR SLAM engine (same layout as the JAX package).

Numerics: every float tensor is float32 and float32 matrix products run in
full float32.  TF32 would truncate matmul inputs to ~3 decimal digits, which
breaks the norm-expansion distance matrices far from the origin (see
``match/bruteforce.py::pairwise_sqdist``), so it is switched off here and
stays off for the whole process.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
