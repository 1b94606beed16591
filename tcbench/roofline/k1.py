"""K1's counted work (the coupled integration), from the shapes of the
model and the reference's own tracks, never from the kernel.

The counts follow the algorithm (the reference model, tcbench/reference/
model.py) at wind width W = 2L for L steering levels, with a fused
multiply-add as two operations and a transcendental as one, and count
only what the delivered tracks need: alive storm-steps, the gathers of
alive storms, and each distinct corner-packed cell row once a launch.
Every count is a lower bound, so the share it gives cannot pass 100%.
"""


def cell_channels(W: int) -> int:
    """A cell row's channels: the W means, the W(W+1)/2 covariance
    entries, five environment fields, land and bathymetry."""
    return W + W * (W + 1) // 2 + 5 + 2


def rhs_flops(W: int) -> int:
    """One right-hand side: the steering weights (a multiply-add and a
    clip per level), the two steering sums (a multiply-add per wind
    component), and 48 for the beta drift, the translation speed, the
    ocean feedback, dv/dt, the ventilation, dm/dt and the position
    tendencies."""
    L = W // 2
    return 4 * L + 2 * W + 48


def step_flops(W: int) -> int:
    """An alive storm-step: the colouring of F(t) through the lower
    triangle (a multiply-add per entry), four right-hand sides, and the
    RK4 stage and final combinations (56)."""
    return W * (W + 1) + 4 * rhs_flops(W) + 56


def gather_flops(W: int) -> int:
    """A field gather: the bilinear blend (three multiply-add lerps a
    channel) and the Cholesky factor (W^3/6 multiply-adds, W square
    roots, W reciprocals and the W(W-1)/2 scalings)."""
    return 6 * cell_channels(W) + W ** 3 // 3 + 2 * W + W * (W - 1) // 2


def step_bytes(W: int) -> int:
    """An alive storm-step: F(t) read (4W), and lon, lat, v, m, the alive
    flag and the W winds written."""
    return 4 * W + 16 + 1 + 4 * W


STORM_BYTES = 42      # the start state, plane, boundary-layer depth,
                      # genesis flag and end state of a storm


def cell_bytes(W: int) -> int:
    return 4 * 4 * cell_channels(W)


def flops(W: int, work: dict) -> float:
    return (work['storm_steps'] * step_flops(W)
            + work['gathers'] * gather_flops(W))


def nbytes(W: int, work: dict) -> float:
    return (work['storm_steps'] * step_bytes(W)
            + work['storms'] * STORM_BYTES + work['cells'] * cell_bytes(W))
