"""tropical_cyclone_risk_tpu_torch: the PyTorch + CUDA port of
tropical_cyclone_risk_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's layout and function names; its hot functions are
hand-written kernels (kernels/: the CUDA integrator K1, the Triton vmax pass
K2, the CUDA seeding kernel K3, the CUDA threefry kernel K5, the CUDA
CAPE-PI kernel K6), each beside a plain PyTorch twin that CPU tensors
take.  It imports torch and never jax, and nothing of the JAX
package: what it needs of the JAX package's jax-free modules (config,
constants, io, preprocess, utils.obs) it keeps as its own copies.  Entry
points: ``cli.main`` (``python -m tropical_cyclone_risk_tpu_torch.cli``)
and ``runtime.run_downscaling``; both run on the GPU unless asked for the
CPU.
"""

from tropical_cyclone_risk_tpu_torch.config import Namelist

__all__ = ['Namelist']
