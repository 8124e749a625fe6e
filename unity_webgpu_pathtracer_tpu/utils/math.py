"""Batched vector math for the render path.

All functions operate on arrays whose *last* axis is the vector axis (shape
``(..., 3)``), so every op vectorizes over the ray batch and fuses under
``jit``.  Semantics mirror the reference's HLSL helpers in
``Assets/Resources/util/common.hlsl`` (luminance :195, ONB :343-384,
concentric disk :285-341) without translating its scalar control flow —
branches become ``jnp.where`` selects.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPSILON = 1.0e-4
PI = 3.14159265358979323
INV_PI = 0.31830988618379067
TWO_PI = 6.28318530717958648
INV_TWO_PI = 0.15915494309189533
INV_4_PI = 0.07957747154594766
FAR_PLANE = 1.0e5


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the last axis, keeps no dims.

    3-wide dots are written in component form: a ``reduce`` over the minor
    axis can end an XLA fusion, and the production transition contains
    dozens of them.  Component adds are plain elementwise ops and fuse
    freely."""
    p = a * b
    if p.shape[-1] == 3:
        return p[..., 0] + p[..., 1] + p[..., 2]
    return jnp.sum(p, axis=-1)


def dot1(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product, keepdims=True (broadcasts against vectors)."""
    return dot(a, b)[..., None]


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(v, v), 0.0))


def normalize(v: jnp.ndarray, eps: float = 1.0e-20) -> jnp.ndarray:
    """Normalize over the last axis; zero vectors stay (near) zero."""
    return v * jax_rsqrt(jnp.maximum(dot1(v, v), eps))


def jax_rsqrt(x: jnp.ndarray) -> jnp.ndarray:
    return 1.0 / jnp.sqrt(x)


def luminance(color: jnp.ndarray) -> jnp.ndarray:
    """Rec.601 luma, matching ``common.hlsl:195-198`` (component form —
    see :func:`dot` for why there is no axis reduce here)."""
    return (color[..., 0] * jnp.asarray(0.299, color.dtype)
            + color[..., 1] * jnp.asarray(0.587, color.dtype)
            + color[..., 2] * jnp.asarray(0.114, color.dtype))


def sqr(x: jnp.ndarray) -> jnp.ndarray:
    return x * x


def reflect(incident: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """HLSL ``reflect``: ``i - 2*dot(i,n)*n`` (incident points *toward* surface)."""
    return incident - 2.0 * dot1(incident, normal) * normal


def refract(incident: jnp.ndarray, normal: jnp.ndarray, eta) -> jnp.ndarray:
    """HLSL ``refract``; returns 0-vector on total internal reflection."""
    eta = jnp.asarray(eta)[..., None] if jnp.ndim(eta) else eta
    cos_i = -dot1(incident, normal)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    refr = eta * incident + (eta * cos_i - jnp.sqrt(jnp.maximum(k, 0.0))) * normal
    return jnp.where(k < 0.0, 0.0, refr)


def safe_rcp(v: jnp.ndarray) -> jnp.ndarray:
    """Reciprocal with +/-inf passthrough like HLSL ``rcp`` (common.hlsl:205).

    The traversal slab test relies on IEEE inf semantics: a zero direction
    component yields +/-inf which resolves correctly through min/max.
    Exactly-zero components are nudged off zero to avoid 0*inf = nan.
    """
    tiny = jnp.asarray(1.0e-30, dtype=v.dtype)
    v = jnp.where(v == 0.0, tiny, v)
    return 1.0 / v


def build_onb(z: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Orthonormal basis (tangent, bitangent, normal) from direction ``z``.

    Branch-free port of the reference's default ONB (frisvad variant with a
    guard for z == -Z, ``common.hlsl:365-375``, ONB_METHOD 1).  Returns the
    three world-space basis vectors; ``z`` need not be unit length (it is
    normalized here, degenerate input yields the identity frame).
    """
    len_sq = dot1(z, z)
    zn = normalize(z)
    zx, zy, zz = zn[..., 0:1], zn[..., 1:2], zn[..., 2:3]
    k = 1.0 / jnp.maximum(1.0 + zz, 1.0e-5)
    a = zy * k
    b = zy * a
    c = -zx * a
    x = normalize(jnp.concatenate([zz + b, c, -zx], axis=-1))
    y = normalize(jnp.concatenate([c, 1.0 - b, -zy], axis=-1))
    # Degenerate (zero-length) input -> identity basis, matching the HLSL guard.
    degenerate = len_sq == 0.0
    ex = jnp.zeros_like(zn).at[..., 0].set(1.0)
    ey = jnp.zeros_like(zn).at[..., 1].set(1.0)
    ez = jnp.zeros_like(zn).at[..., 2].set(1.0)
    x = jnp.where(degenerate, ex, x)
    y = jnp.where(degenerate, ey, y)
    zn = jnp.where(degenerate, ez, zn)
    return x, y, zn


def to_world(onb, local: jnp.ndarray) -> jnp.ndarray:
    """``common.hlsl:386-389`` — local (tangent-space) vector to world."""
    x, y, z = onb
    return (
        x * local[..., 0:1] + y * local[..., 1:2] + z * local[..., 2:3]
    )


def to_local(onb, world: jnp.ndarray) -> jnp.ndarray:
    """``common.hlsl:391-394`` — world vector into the tangent frame."""
    x, y, z = onb
    return jnp.stack([dot(x, world), dot(y, world), dot(z, world)], axis=-1)


def concentric_sample_disk(u1: jnp.ndarray, u2: jnp.ndarray):
    """Concentric square->disk map (``common.hlsl:285-341``), branch-free.

    Returns ``(dx, dy)`` on the unit disk. Used by the thin-lens camera.
    """
    sx = 2.0 * u1 - 1.0
    sy = 2.0 * u2 - 1.0
    # Region selection replicated with selects instead of nested ifs.
    r1_cond = sx >= -sy
    r_a = jnp.where(sx > sy, sx, sy)                       # regions 1/2
    theta_a = jnp.where(
        sx > sy,
        jnp.where(sy > 0.0, sy / jnp.where(r_a == 0, 1, r_a),
                  8.0 + sy / jnp.where(r_a == 0, 1, r_a)),
        2.0 - sx / jnp.where(r_a == 0, 1, r_a),
    )
    r_b = jnp.where(sx <= sy, -sx, -sy)                    # regions 3/4
    theta_b = jnp.where(
        sx <= sy,
        4.0 - sy / jnp.where(r_b == 0, 1, r_b),
        6.0 + sx / jnp.where(r_b == 0, 1, r_b),
    )
    r = jnp.where(r1_cond, r_a, r_b)
    theta = jnp.where(r1_cond, theta_a, theta_b) * (PI / 4.0)
    degenerate = jnp.logical_and(sx == 0.0, sy == 0.0)
    dx = jnp.where(degenerate, 0.0, r * jnp.cos(theta))
    dy = jnp.where(degenerate, 0.0, r * jnp.sin(theta))
    return dx, dy


def face_forward(normal: jnp.ndarray, direction: jnp.ndarray) -> jnp.ndarray:
    """Pick the normal hemisphere facing against ``direction`` (bvh.hlsl:208)."""
    return jnp.where(dot1(normal, direction) <= 0.0, normal, -normal)


def matmul_f32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """``a @ b`` in full f32: never TF32 or bf16 passes, whatever the
    backend's default matmul precision."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def gather_small(table: jnp.ndarray, idx: jnp.ndarray,
                 max_onehot: int = 64) -> jnp.ndarray:
    """Row gather that routes small tables through a one-hot matmul.

    A one-hot (B, M) @ (M, W) matmul replaces the gather for M <= 64; it
    is bit-exact at HIGHEST precision (the f32 product keeps every
    mantissa bit; the one-hot side is exact 0/1).  Whether it beats a
    plain gather on the GPU is not measured.
    """
    m = table.shape[0]
    if m > max_onehot:
        return table[idx]
    if jnp.issubdtype(table.dtype, jnp.integer):
        # Small ints survive the f32 round trip exactly (< 2^24).
        f = gather_small(table.astype(jnp.float32), idx, max_onehot)
        return jnp.round(f).astype(table.dtype)
    onehot = (idx[..., None] == jnp.arange(m, dtype=idx.dtype)).astype(
        table.dtype
    )
    return jax.lax.dot_general(
        onehot, table,
        dimension_numbers=(((onehot.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=table.dtype,
    )
