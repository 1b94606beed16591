"""tropical_cyclone_risk_tpu_torch: the PyTorch + CUDA port of
tropical_cyclone_risk_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's layout and function names; its hot loops are
hand-written kernels (kernels/: the CUDA integrator K1, the Triton vmax pass
K2), each beside a plain PyTorch twin that CPU tensors take.  It imports
torch and never jax; the JAX package's jax-free modules (config, constants,
io.netcdf, utils.obs) are shared as they are.  Entry point:
``runtime.run_downscaling``.
"""

from tropical_cyclone_risk_tpu.config import Namelist

__all__ = ['Namelist']
