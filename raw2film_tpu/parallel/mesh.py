"""Device mesh + sharded batch rendering.

The reference's only cross-device construct is a producer/consumer queue
overlapping host decode with GPU passes (reference:
src/raw2film/gui_objects.py:65-115). Here: shard the *image batch* across
devices with ``jax.sharding`` — and optionally shard the image rows
("space" axis) so a single huge frame can exceed one device's memory, with
explicit halo exchanges between row shards (``space_mode="halo"``) or XLA's
SPMD partitioner (``"spmd"``). ``make_mesh`` reshapes ``jax.devices()``
without regard to topology, which suits all-to-all links such as NVLink.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from raw2film_tpu.pipeline.render import RenderConfig, render_chain


def make_mesh(
    n_devices: int | None = None, batch: int | None = None, space: int | None = None
) -> Mesh:
    """Build a (batch, space) mesh. Defaults: all devices on the batch axis."""
    devices = np.asarray(jax.devices())
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(
            f"make_mesh: {n} devices requested but only {len(devices)} "
            f"available ({jax.devices()[0].platform}); for a virtual mesh set "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n} and "
            f"JAX_PLATFORMS=cpu before jax initializes backends"
        )
    devices = devices[:n]
    if batch is None and space is None:
        batch, space = n, 1
    elif batch is None:
        batch = n // space
    elif space is None:
        space = n // batch
    if batch * space != n:
        raise ValueError(
            f"make_mesh: batch*space ({batch}*{space}) must equal n devices ({n})"
        )
    return Mesh(devices.reshape(batch, space), ("batch", "space"))


def batch_render_fn(cfg: RenderConfig):
    """Batched render: (B, 3, H, W) xyz + per-image keys -> (B, 3, H, W) u8.

    Uses lax.map (a device-side loop), not vmap: one frame's temporaries
    live at a time, and a loop has the same throughput for full-frame work.
    """

    def fn(xyz_batch, bundle, keys, grain_row_offset=0, burn_ref_hw=None):
        return jax.lax.map(
            lambda xk: render_chain(
                xk[0], bundle, cfg, xk[1], grain_row_offset, burn_ref_hw
            ),
            (xyz_batch, keys),
        )

    return fn


def space_halo_rows(cfg: RenderConfig, h: int, w: int) -> int:
    """Overlap margin (rows) for the halo space path: the SUMMED spatial
    support of the cascaded stages (a seam row's MTF inputs are halation
    outputs whose own inputs reach further into the pad — max() of the
    supports under-halos). Halation's exact kernel radius is
    scale/4 * halation_size px (reference: effects.py:200-217); the MTF
    kernel is ~0.1 mm wide plus the unsharp sigma; highlight burn's
    down-up blur spans ~6 * ceil(min(h,w)/burn_scale) full-res px."""
    halo = 8.0
    if cfg.halation:
        halo += cfg.scale / 4.0 * cfg.halation_size
    if cfg.sharpness and cfg.has_mtf:
        halo += 0.08 * cfg.scale + 4.0 * max(cfg.sharpening_sigma, 0.0)
    if cfg.chroma_nr:
        halo += 2.0 * cfg.chroma_nr + 1
    if cfg.highlight_burn:
        import math

        # Blur support in low-res cells (sigma=3 trunc=2 -> radius ~7) plus
        # one bilinear cell, plus one cell of slack for the global-grid
        # alignment slice (ops/burn.py::_aligned_slice drops a partial cell
        # at the strip bottom).
        f = math.ceil(min(h, w) / cfg.burn_scale)
        halo += 9.0 * f
    return int(-(-halo // 8) * 8)


def sharded_batch_render(mesh: Mesh, cfg: RenderConfig, space_mode: str = "halo"):
    """jit the batched render with the batch axis sharded over the mesh's
    'batch' axis (each device loops its local shard) and image rows over
    'space'. Bundle arrays are replicated.

    ``space_mode`` picks the space-axis strategy:

    * ``"halo"`` (default) — overlap-and-discard: each device receives its
      row shard plus a halo of neighbor rows (two ``ppermute``s), runs the
      FULL chain locally and crops the halo. When the overlap exceeds a
      shard's height (large halation radii over a tall space axis) the
      exchange chains multiple ppermute hops instead of truncating. Boundary
      semantics: interior shard seams are exact for the conv stages AND for
      grain (the hash rows shift to global coordinates via render_chain's
      grain_row_offset, so every shard evaluates the same stateless field)
      AND for highlight burn (the low-res glow grid is aligned to the global
      frame via the same offset); frame edges replicate the edge row into
      the pad (a cascaded-clamp approximation). See tests/test_parallel.py
      for the measured gates.
    * ``"spmd"`` — delegate to XLA's SPMD partitioner (exact conv halos;
      kept for small frames and cross-checking).
    """
    # A sharded export program is the most expensive compile in the system:
    # make sure it lands in the persistent cache so a mesh/shape recurrence
    # pays a file read, not a compile.
    from raw2film_tpu.config import enable_persistent_jit_cache

    enable_persistent_jit_cache()
    shard_map = partial(jax.shard_map, check_vma=False)

    in_spec = P("batch", None, "space", None)
    key_spec = P("batch")
    fn = batch_render_fn(cfg)

    if mesh.shape.get("space", 1) == 1:
        body = shard_map(
            fn,
            mesh=mesh,
            in_specs=(in_spec, P(), key_spec),
            out_specs=in_spec,
        )
        return jax.jit(body)

    space = mesh.shape["space"]

    if space_mode == "halo":

        def body(xyz, bundle, keys):
            # xyz: local (B_loc, 3, h_loc, w) row shard.
            h_loc, w = xyz.shape[-2:]
            halo = space_halo_rows(cfg, h_loc * space, w)
            idx = jax.lax.axis_index("space")
            if halo < h_loc:
                # Fast path: one hop each way.
                fwd = [(i, i + 1) for i in range(space - 1)]
                bwd = [(i + 1, i) for i in range(space - 1)]
                top = jax.lax.ppermute(xyz[:, :, -halo:, :], "space", fwd)
                bot = jax.lax.ppermute(xyz[:, :, :halo, :], "space", bwd)
                # Edge shards got zeros: fill with REFLECT-101 rows around
                # the frame edge — the same boundary convention every conv
                # in the chain uses (ops/conv.py PAD_MODE) — so border rows
                # of a sharded render match the unsharded one exactly.
                # halo < h_loc guarantees rows 1..halo exist locally.
                top_ref = jnp.flip(xyz[:, :, 1 : halo + 1, :], axis=2)
                bot_ref = jnp.flip(xyz[:, :, -halo - 1 : -1, :], axis=2)
                top = jnp.where(idx == 0, top_ref, top)
                bot = jnp.where(idx == space - 1, bot_ref, bot)
                padded = jnp.concatenate([top, xyz, bot], axis=2)
            else:
                # The required overlap exceeds one shard (large halation at
                # export scale over a tall space axis): chain ppermutes so
                # hop k delivers the needed rows of shard idx∓k — the halo is
                # assembled in full rather than silently truncated. Rows that
                # would come from beyond the frame (including hops past the
                # mesh edge) are REFLECT-101-filled afterwards via a row
                # gather (the reflected source rows may live in a neighbor's
                # shard — they are already present in `padded` by then),
                # matching the one-hop path's frame-edge
                # semantics.
                hops = -(-halo // h_loc)
                top_parts, bot_parts = [], []
                for k in range(1, hops + 1):
                    rows_k = min(h_loc, halo - (k - 1) * h_loc)
                    if k < space:
                        fwd = [(i, i + k) for i in range(space - k)]
                        bwd = [(i + k, i) for i in range(space - k)]
                        top_parts.append(
                            jax.lax.ppermute(xyz[:, :, -rows_k:, :], "space", fwd)
                        )
                        bot_parts.append(
                            jax.lax.ppermute(xyz[:, :, :rows_k, :], "space", bwd)
                        )
                    else:
                        # No source shard exists at this distance for ANY
                        # device: the gather below edge-fills these rows.
                        shape = xyz.shape[:2] + (rows_k,) + xyz.shape[3:]
                        zeros = jnp.zeros(shape, xyz.dtype)
                        top_parts.append(zeros)
                        bot_parts.append(zeros)
                # Farthest hop first on top so rows run in global order.
                padded = jnp.concatenate(
                    top_parts[::-1] + [xyz] + bot_parts, axis=2
                )
                # Reflect every out-of-frame padded row around the frame
                # boundary: padded row r is global row idx*h_loc - halo + r;
                # global row 0 sits at padded row halo - idx*h_loc, the last
                # at that + space*h_loc - 1. Interior shards reflect nothing
                # (bounds outside the array); edge shards mirror in-frame
                # rows (reflect-101), with a final clip as the backstop for
                # the pathological halo > frame-height case (double
                # reflection territory — clamp is fine there).
                r = jnp.arange(padded.shape[2])
                lo = halo - idx * h_loc
                hi = lo + space * h_loc - 1
                r = jnp.where(r < lo, 2 * lo - r, r)
                r = jnp.where(r > hi, 2 * hi - r, r)
                gather = jnp.clip(r, lo, hi)
                padded = jnp.take_along_axis(
                    padded, gather[None, None, :, None], axis=2
                )
            # Grain hash rows in GLOBAL image coordinates (padded row 0 is
            # global row idx*h_loc - halo) so seams are grain-exact; burn's
            # blur factor pinned to the GLOBAL frame size so every shard
            # matches the single-device tone mapping.
            out = fn(
                padded, bundle, keys, idx * h_loc - halo,
                (h_loc * space, w),
            )
            return out[:, :, halo:-halo, :]

        return jax.jit(
            shard_map(
                body,
                mesh=mesh,
                in_specs=(in_spec, P(), key_spec),
                out_specs=in_spec,
            )
        )

    # "spmd": XLA partitions the whole traced chain.
    in_shard = NamedSharding(mesh, in_spec)
    key_shard = NamedSharding(mesh, key_spec)
    repl = NamedSharding(mesh, P())
    return jax.jit(
        fn,
        in_shardings=(in_shard, repl, key_shard),
        out_shardings=in_shard,
    )
