"""Hand-written Hopper kernels of the port and their launch counters.

- ``integrator`` (K1): the fused track integrator, CUDA C++ for sm_90a
  (csrc/integrator.cu).
- ``vmax`` (K2): the vmax diagnostic pass, a Triton kernel.
- ``cape_pi`` (K6): potential intensity per column, CUDA C++ for sm_90a
  (csrc/cape_pi.cu).

The CUDA sources are built with nvcc at first use (kernels/build.py) and
bound with ctypes.  Each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel and nowhere else.  Each plain twin adds one to
``PLAIN_ON_CUDA[name]`` when it is called with CUDA tensors, which the main
path never does (it is only done on purpose, to compare a kernel with its
twin).
"""

LAUNCHES = {'integrator': 0, 'vmax': 0, 'cape_pi': 0}
PLAIN_ON_CUDA = {'integrator': 0, 'vmax': 0, 'cape_pi': 0}


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_ON_CUDA):
        for name in counts:
            counts[name] = 0
