"""2D SPH smoothing kernels and equation of state.

Pure elementwise functions (broadcast over any shape).
Math matches the reference WGSL library (``funcs.wgsl:71-154``); the 2D
normalization constants match the host-side precompute
(``src/simulation.rs:486-490``):

    poly6 volume      4/(pi h^8)
    poly6 gradient   24/(pi h^8)
    poly6 laplacian   8/(pi h^8)
    spiky derivative 12/(pi h^4)
    viscosity        15/(2 pi h^3)

All branches are expressed as ``jnp.where`` with division-safe operands so
masked lanes contribute exactly +0.0 (keeps sorted-neighbor and all-pairs
reductions bitwise identical).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..params import PI


def poly6(h, r2):
    """Poly6 kernel W(r) = 4/(pi h^8) (h^2 - r^2)^3 for r2 <= h^2 (funcs.wgsl:72-78)."""
    h2 = h * h
    h4 = h2 * h2
    norm = 4.0 / (PI * (h4 * h4))
    diff = h2 - r2
    return jnp.where(r2 > h2, 0.0, norm * diff * diff * diff)


def poly6_gradient(h, r_vec):
    """Vector gradient of poly6; zero at r=0 and r>=h (funcs.wgsl:81-88)."""
    r_len = jnp.linalg.norm(r_vec, axis=-1, keepdims=True)
    h2 = h * h
    h4 = h2 * h2
    const = -24.0 / (PI * (h4 * h4))
    diff2 = h2 - r_len * r_len
    out = const * diff2 * diff2 * r_vec
    bad = (r_len >= h) | (r_len == 0.0)
    return jnp.where(bad, 0.0, out)


def poly6_laplacian(h, r):
    """Scalar laplacian form 8/(pi h^8)(h^2-r^2)(3h^2-4r^2) for r<=h (funcs.wgsl:91-98)."""
    h2 = h * h
    h4 = h2 * h2
    const = 8.0 / (PI * (h4 * h4))
    r2 = r * r
    return jnp.where(r > h, 0.0, const * (h2 - r2) * (3.0 * h2 - 4.0 * r2))


def spiky_derivative(h, r, norm):
    """Spiky kernel derivative -(h-r)*norm for r<=h, norm=12/(pi h^4) (funcs.wgsl:101-109)."""
    return jnp.where(r <= h, -(h - r) * norm, 0.0)


def viscosity(h, r, norm):
    """Viscosity kernel, norm=15/(2 pi h^3) (funcs.wgsl:112-123).

    Returns ``norm`` exactly at r=0 (the reference's special case).
    """
    h3 = h * h * h
    safe_r = jnp.where(r == 0.0, 1.0, r)
    r2 = safe_r * safe_r
    val = norm * (
        -(r2 * safe_r) / (2.0 * h3) + r2 / (h * h) + h / (2.0 * safe_r) - 1.0
    )
    val = jnp.where(r == 0.0, norm, val)
    return jnp.where(r <= h, val, 0.0)


def pressure_eos(density, pressure_constant, rest_density):
    """Linear EOS p = k (rho - rho0) (funcs.wgsl:152-154)."""
    return pressure_constant * (density - rest_density)
