"""PyTorch/CUDA port of ``deepmimic_mujoco_tpu`` (the JAX package stays the
reference and is never imported from here).

Float32 throughout.  TF32 is switched off for matmuls and convolutions: the
Newton–Schulz mass-matrix inverse (``physics/engine.py:mass_inverse``) needs
full f32 products to reach its residual, and the parity tests compare with
the JAX reference computed in f32 on the CPU.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
