"""Quantization utilities: stochastic rounding for low-precision tables.

bfloat16 embedding tables halve HBM footprint and double gather/scatter
bandwidth, but deterministic round-to-nearest on updates loses small
gradient contributions (lr * g often underflows a bf16 ulp). Stochastic
rounding makes the expected value of the stored row equal to the f32
update, which is the standard production fix for low-precision embedding
training.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from keras_rs_tpu.types import Tensor


def stochastic_round_bf16(x: Tensor, key: jax.Array) -> Tensor:
    """Rounds f32 -> bf16 stochastically: P(round up) = frac distance.

    bf16 is the top 16 bits of f32, so adding uniform random low-16 bits
    before truncation implements exact stochastic rounding.
    """
    x = x.astype(jnp.float32)
    bits = jax.random.bits(key, x.shape, jnp.uint32)
    xi = jax.lax.bitcast_convert_type(x, jnp.uint32)
    rounded = xi + (bits & jnp.uint32(0xFFFF))
    hi = (rounded >> 16).astype(jnp.uint16)
    return jax.lax.bitcast_convert_type(hi, jnp.bfloat16)


def quantize_rows_int8(table: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric per-row int8 quantization for inference tables.

    Returns `(q, scale)` with `q` int8 [R, dim] and `scale` f32 [R, 1]
    such that `q * scale ~= table` (max abs error <= scale/2 per
    element, i.e. absmax/254 per row). Zero rows get scale 1 so the
    dequantized row is exactly zero. 4x less serving memory than f32
    (2x vs bf16). Same scheme as the int8 asymmetric-hashing store in
    layers/retrieval/kmeans_retrieval.py.
    """
    x = jnp.asarray(table, jnp.float32)
    absmax = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
    scale = jnp.where(absmax > 0, absmax / 127.0, 1.0)
    q = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
    return q, scale


def dequantize_rows(q: Tensor, scale: Tensor) -> Tensor:
    """Inverse of `quantize_rows_int8` (up to rounding)."""
    return q.astype(jnp.float32) * scale


def pack_rows_int8_groups(q: Tensor) -> Tensor:
    """int8 [R, dim] -> int32 [ceil(R/4), dim]: 4 consecutive rows
    byte-interleaved per COLUMN of the packed row
    (word[g, d] = q[4g, d] | q[4g+1, d]<<8 | q[4g+2, d]<<16
    | q[4g+3, d]<<24).

    A word-typed serving-lookup layout: the packed table keeps a full
    int32 minor dimension (exactly 1 byte/element amortized), and a row
    fetch becomes ONE 32-bit gather of the 4-row group followed by two
    in-register shifts (`take_rows_int8_packed`). R is padded to a
    multiple of 4 with zero rows.

    Built from 2-D strided slices + shifts ONLY: a bitcast of a
    [G, dim, 4] int8 array would need a minor dimension of 4, which
    tiled layouts pad many-fold.
    """
    q = jnp.asarray(q)
    if q.dtype != jnp.int8 or q.ndim != 2:
        raise ValueError(
            f"expected int8 [R, dim], got {q.dtype} {q.shape}"
        )
    R, dim = q.shape
    pad = (-R) % 4
    if pad:
        q = jnp.pad(q, ((0, pad), (0, 0)))
    b = q.astype(jnp.int32) & 0xFF  # [4G, dim], zero-extended bytes
    w = (
        b[0::4]
        | (b[1::4] << 8)
        | (b[2::4] << 16)
        | (b[3::4] << 24)
    )
    return w.astype(jnp.int32)


def unpack_rows_int8_groups(packed: Tensor, rows: int) -> Tensor:
    """Inverse of `pack_rows_int8_groups` (drops the padding rows)."""
    g, dim = packed.shape
    w = jnp.asarray(packed, jnp.int32)
    # Arithmetic shift sign-extends each byte lane back to int8 range.
    lanes = [((w << (24 - 8 * k)) >> 24) for k in range(4)]
    q = jnp.stack(lanes, axis=1).reshape(g * 4, dim)
    return q.astype(jnp.int8)[:rows]


def take_rows_int8_packed(
    packed: Tensor, scale: Tensor, ids: Tensor
) -> Tensor:
    """Dequantized f32 rows from the group-packed layout.

    `packed` int32 [ceil(R/4), dim] (pack_rows_int8_groups), `scale`
    f32 [R] (1-D: avoids both a second row-descriptor per id and the
    [R, 1] tile-padding), `ids` any integer shape; returns
    f32 ids.shape + (dim,). The byte extraction is INTEGER shift
    arithmetic — left-shift to the sign position then arithmetic
    right-shift sign-extends, with no lane select or float one-hot.
    """
    dim = packed.shape[1]
    flat = ids.reshape(-1)
    words = jnp.take(
        packed, flat // 4, axis=0, mode="clip"
    )  # [N, dim] int32
    shift = (24 - 8 * (flat % 4)).astype(jnp.int32)[:, None]
    rows = (words << shift) >> 24  # [N, dim] sign-extended bytes
    out = rows.astype(jnp.float32) * jnp.take(
        scale, flat, mode="clip"
    )[:, None]
    return out.reshape(tuple(ids.shape) + (dim,))


def pack_rows_int8_fused(q: Tensor, scale: Tensor) -> Tensor:
    """int8 [R, dim] + f32 [R] scales -> int32 [ceil(R/8), 256 + 128]:
    eight rows AND their eight scales per packed group row.

    The separate per-row scale gather is a second scattered read per
    lookup (tools/probe_int8_serving.py times it). This layout makes
    the scale ride the SAME gathered row as the data: group g packs rows
    8g..8g+7 column-byte-interleaved in two 128-word planes
    (plane p word d = rows 8g+4p..8g+4p+3 at column d, little-endian
    bytes) followed by the 8 scales (f32 bitcast) and 120 pad words —
    384 words = 3 exact lane tiles, 1.5 B/element amortized (2.67x
    smaller than f32, 1.4x bigger than bare int8+scale), ONE gather
    descriptor per lookup.

    dim must be exactly 128 (one lane tile per plane); R pads to a
    multiple of 8 with zero rows / scale 1.
    """
    q = jnp.asarray(q)
    scale = jnp.asarray(scale, jnp.float32).reshape(-1)
    if q.dtype != jnp.int8 or q.ndim != 2 or q.shape[1] != 128:
        raise ValueError(
            f"expected int8 [R, 128], got {q.dtype} {q.shape}"
        )
    if scale.shape[0] != q.shape[0]:
        raise ValueError(
            f"scale rows {scale.shape[0]} != table rows {q.shape[0]}"
        )
    R, dim = q.shape
    pad = (-R) % 8
    if pad:
        q = jnp.pad(q, ((0, pad), (0, 0)))
        scale = jnp.pad(scale, (0, pad), constant_values=1.0)
    G = (R + pad) // 8
    b = q.astype(jnp.int32) & 0xFF  # [8G, dim]
    planes = []
    for p in range(2):
        base = 4 * p
        planes.append(
            b[base::8]
            | (b[base + 1 :: 8] << 8)
            | (b[base + 2 :: 8] << 16)
            | (b[base + 3 :: 8] << 24)
        )  # [G, dim] each
    scales8 = jax.lax.bitcast_convert_type(
        scale.reshape(G, 8), jnp.int32
    )
    padw = jnp.zeros((G, 384 - 2 * dim - 8), jnp.int32)
    return jnp.concatenate(planes + [scales8, padw], axis=1)


def unpack_rows_int8_fused(
    packed: Tensor, rows: int
) -> tuple[Tensor, Tensor]:
    """Inverse of `pack_rows_int8_fused` (drops padding rows)."""
    G = packed.shape[0]
    w = jnp.asarray(packed, jnp.int32)
    qs = []
    for p in range(2):
        plane = w[:, p * 128 : (p + 1) * 128]  # [G, 128]
        for k in range(4):
            qs.append(((plane << (24 - 8 * k)) >> 24).astype(jnp.int8))
    # qs order: rows 8g+0..3 (plane 0), 8g+4..7 (plane 1).
    q = jnp.stack(qs, axis=1).reshape(G * 8, 128)
    scale = jax.lax.bitcast_convert_type(
        w[:, 256:264], jnp.float32
    ).reshape(G * 8)
    return q[:rows], scale[:rows]


def take_rows_int8_fused(packed: Tensor, ids: Tensor) -> Tensor:
    """Dequantized f32 rows from the fused layout — ONE gather
    descriptor per id (data and scale arrive together)."""
    flat = ids.reshape(-1)
    w = jnp.take(packed, flat // 8, axis=0, mode="clip")  # [N, 384]
    k = (flat % 8).astype(jnp.int32)
    plane = jnp.where(
        (k < 4)[:, None], w[:, 0:128], w[:, 128:256]
    )  # [N, 128]
    shift = (24 - 8 * (k % 4))[:, None]
    rows = (plane << shift) >> 24  # sign-extended bytes
    scales8 = jax.lax.bitcast_convert_type(
        w[:, 256:264], jnp.float32
    )  # [N, 8]
    # Vectorized lane select, NOT take_along_axis: the latter lowers to
    # N one-element gathers — the scalar gather this layout exists to
    # avoid. An 8-lane masked sum is pure elementwise work.
    sel = k[:, None] == jnp.arange(8, dtype=jnp.int32)[None, :]
    scale = jnp.sum(
        jnp.where(sel, scales8, jnp.float32(0.0)), axis=1
    )  # [N]
    out = rows.astype(jnp.float32) * scale[:, None]
    return out.reshape(tuple(ids.shape) + (128,))


def cast_rows_for_storage(
    x: Tensor, dtype: jnp.dtype, key: jax.Array | None
) -> Tensor:
    """Casts updated rows to the table's storage dtype.

    f32 passes through; bf16 uses stochastic rounding when a key is given,
    else round-to-nearest.
    """
    if dtype == jnp.float32:
        return x.astype(jnp.float32)
    if dtype == jnp.bfloat16:
        if key is None:
            return x.astype(jnp.bfloat16)
        return stochastic_round_bf16(x, key)
    raise ValueError(f"Unsupported table dtype: {dtype}")
