"""Hand-written Hopper kernels of the port and their launch counters.

- ``integrator`` (K1): the fused track integrator, CUDA C++ for sm_90a
  (csrc/integrator.cu), with land and bathymetry in the cell row or on
  grids of their own, two, three or four steering levels, and the in-scan
  vmax.
- ``vmax`` (K2): the vmax diagnostic pass, CUDA C++ for sm_90a
  (csrc/vmax.cu).
- ``vmax_last``: K2's second entry, the in-scan vmax's re-derivation of
  each track's final sample, banked into the lifetime peak, over every
  segment of a launch in one launch (csrc/vmax.cu).
- ``seeding`` (K3): genesis seeding in one launch, lazily drawn proposal
  rounds shared over each warp's lanes, the stream keys derived on the
  card, CUDA C++ for sm_90a (csrc/seeding.cu).
- ``threefry`` (K5): the threefry2x32 stream and its bits / uniform /
  normal / randint samplers, and the fused draw_fourier at full width or
  at the rows a launch integrates, CUDA C++ for sm_90a (csrc/rng.cu; its
  device functions, csrc/threefry.cuh, are shared with K3).
- ``compact`` (K4): the launch's compactions (the stable partition order
  with its row gathers and maps, and the survivor stitch), CUDA C++ for
  sm_90a (csrc/compact.cu).
- ``cape_pi`` (K6): potential intensity per column, the level-only and
  column-only work computed once, CUDA C++ for sm_90a (csrc/cape_pi.cu).
- ``genesis`` (K7): the step-0 genesis gate, CUDA C++ for sm_90a, a second
  kernel of csrc/integrator.cu that reuses K1's blend, Cholesky and
  coloring on rows staged in shared memory with cp.async.
- ``stacks``: the field stacks, each launch's corner-packed cell rows (and
  the land and bathymetry stacks) written in one pass from the pack's
  planes, CUDA C++ for sm_90a (csrc/stacks.cu); one launch per output,
  three per models/fields.py build_stacks.

The CUDA sources are built with nvcc at first use (kernels/build.py) and
bound with ctypes.  Each wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel and nowhere else.  Each plain twin adds one to
``PLAIN_ON_CUDA[name]`` when it is called with CUDA tensors, which the main
path never does (it is only done on purpose, to compare a kernel with its
twin).
"""

NAMES = ('integrator', 'vmax', 'seeding', 'threefry', 'compact', 'cape_pi',
         'genesis', 'vmax_last', 'stacks')
LAUNCHES = dict.fromkeys(NAMES, 0)
PLAIN_ON_CUDA = dict.fromkeys(NAMES, 0)


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_ON_CUDA):
        for name in counts:
            counts[name] = 0
