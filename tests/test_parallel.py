"""Sharded batch rendering on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raw2film_tpu.film import chain as fchain
from raw2film_tpu.film.loader import load_film_stocks
from raw2film_tpu.parallel.mesh import batch_render_fn, make_mesh, sharded_batch_render
from raw2film_tpu.pipeline.params import ImageParams, ProfileParams, merge_params
from raw2film_tpu.pipeline.render import build_render_config, make_film_bundle

STOCKS = load_film_stocks()


def _setup(h=64, w=96, **over):
    neg = STOCKS["Kodak Portra 400"]
    prt = STOCKS["Fuji Crystal Archive Maxima"]
    neg_p = fchain.build_negative_params(neg)
    prt_p = fchain.build_print_params(neg, prt, neg_params=neg_p)
    out_p = fchain.build_output_params(neg, prt, prt_p, neg_p)
    bundle = make_film_bundle(neg_p, prt_p, out_p)
    merged = merge_params(ProfileParams(), ImageParams())
    merged.update({"halation": False, "grain": 0, "sharpness": False, **over})
    cfg = build_render_config(neg, prt, "print", max(h, w) / 36.0, merged)
    return bundle, cfg


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
class TestSharding:
    def test_batch_sharded_matches_single(self):
        bundle, cfg = _setup()
        b, h, w = 8, 64, 96
        xyz = jnp.asarray(
            np.abs(np.random.default_rng(0).normal(0.2, 0.1, (b, 3, h, w))).astype(
                np.float32
            )
        )
        keys = jax.random.split(jax.random.PRNGKey(0), b)

        single = jax.jit(batch_render_fn(cfg))(xyz, bundle, keys)

        mesh = make_mesh(8, batch=8, space=1)
        with mesh:
            sharded = sharded_batch_render(mesh, cfg)(xyz, bundle, keys)
        np.testing.assert_array_equal(np.asarray(single), np.asarray(sharded))

    def test_space_sharding_with_convs_matches(self):
        """Row-sharding an image across devices must agree with unsharded
        even through conv stages — for both space strategies: "spmd" (XLA
        halo exchange, exact) and the default "halo" (overlap-and-discard
        with local Pallas-capable chains; interior seams exact, frame edges
        approximate the cascaded clamp)."""
        bundle, cfg = _setup(halation=True, sharpness=True)
        b, h, w = 4, 64, 96
        xyz = jnp.asarray(
            np.abs(np.random.default_rng(1).normal(0.2, 0.1, (b, 3, h, w))).astype(
                np.float32
            )
        )
        keys = jax.random.split(jax.random.PRNGKey(1), b)
        single = jax.jit(batch_render_fn(cfg))(xyz, bundle, keys)
        mesh = make_mesh(8, batch=4, space=2)
        with mesh:
            spmd = sharded_batch_render(mesh, cfg, space_mode="spmd")(
                xyz, bundle, keys
            )
            halo = sharded_batch_render(mesh, cfg, space_mode="halo")(
                xyz, bundle, keys
            )
        # SPMD: conv halos are exchanged exactly; only fp reassociation may
        # flip an 8-bit code at a rounding boundary.
        diff = np.abs(np.asarray(single).astype(int) - np.asarray(spmd).astype(int))
        assert diff.max() <= 1
        # Halo path: seams AND frame borders are exact to a rounding code —
        # edge shards REFLECT-101-fill the out-of-frame halo rows, the same
        # boundary convention every conv in the chain uses, so border pixels
        # see identical inputs to the unsharded render.
        dh = np.abs(np.asarray(single).astype(int) - np.asarray(halo).astype(int))
        assert dh.max() <= 1, dh.max()

    def test_halo_path_interior_seam_exact_at_larger_halo(self):
        """A seam in the MIDDLE of the frame (away from real edges) must be
        invisible: rows around h/2 agree with the unsharded render."""
        bundle, cfg = _setup(halation=True, sharpness=True, highlight_burn=0.3)
        b, h, w = 4, 96, 96
        xyz = jnp.asarray(
            np.abs(np.random.default_rng(3).normal(0.25, 0.1, (b, 3, h, w))).astype(
                np.float32
            )
        )
        keys = jax.random.split(jax.random.PRNGKey(3), b)
        single = jax.jit(batch_render_fn(cfg))(xyz, bundle, keys)
        mesh = make_mesh(8, batch=4, space=2)
        with mesh:
            halo = sharded_batch_render(mesh, cfg, space_mode="halo")(
                xyz, bundle, keys
            )
        dh = np.abs(np.asarray(single).astype(int) - np.asarray(halo).astype(int))
        mid = dh[:, :, h // 2 - 8 : h // 2 + 8, :]
        # Burn's low-res grid can misalign by one cell at the seam; the
        # tone effect is subtle, so the seam stays within a couple codes.
        assert mid.max() <= 3, mid.max()

    def test_halo_path_grain_exact_across_seams(self):
        """Grain hash rows run in GLOBAL coordinates under the halo path:
        the space-sharded render reproduces the single-device grain field
        exactly — interior rows (away from frame edges) are bit-identical
        with grain ON."""
        bundle, cfg = _setup(halation=True, sharpness=True, grain=2)
        b, h, w = 4, 96, 96
        xyz = jnp.asarray(
            np.abs(np.random.default_rng(5).normal(0.25, 0.1, (b, 3, h, w))).astype(
                np.float32
            )
        )
        keys = jax.random.split(jax.random.PRNGKey(5), b)
        single = jax.jit(batch_render_fn(cfg))(xyz, bundle, keys)
        mesh = make_mesh(8, batch=4, space=2)
        with mesh:
            halo = sharded_batch_render(mesh, cfg, space_mode="halo")(
                xyz, bundle, keys
            )
        dh = np.abs(np.asarray(single).astype(int) - np.asarray(halo).astype(int))
        margin = 12
        assert dh[:, :, margin:-margin, :].max() <= 1, dh[:, :, margin:-margin].max()
        # And specifically the seam band at h/2.
        assert dh[:, :, h // 2 - 6 : h // 2 + 6, :].max() <= 1

    def test_halo_multi_hop_when_overlap_exceeds_shard(self):
        """When the required halo exceeds a shard's height (production
        halation radii over a tall space axis) the exchange must chain
        ppermute hops rather than truncate: interior rows stay within one
        code of the unsharded render even with halo > h_loc."""
        from raw2film_tpu.parallel.mesh import space_halo_rows

        # The halo scales with px/mm, so at test-size frames a large
        # halation_size + burn stands in for the production 45MP case where
        # halation_size 2.0 alone pushes the overlap past a shard.
        bundle, cfg = _setup(
            h=64, w=96, halation=True, sharpness=True, halation_size=24.0,
            highlight_burn=0.3,
        )
        b, h, w = 2, 64, 96
        h_loc = h // 4
        halo = space_halo_rows(cfg, h, w)
        assert halo > 2 * h_loc, (halo, h_loc)  # must exercise >=3 hops
        xyz = jnp.asarray(
            np.abs(np.random.default_rng(7).normal(0.25, 0.1, (b, 3, h, w))).astype(
                np.float32
            )
        )
        keys = jax.random.split(jax.random.PRNGKey(7), b)
        single = jax.jit(batch_render_fn(cfg))(xyz, bundle, keys)
        mesh = make_mesh(8, batch=2, space=4)
        with mesh:
            halo_out = sharded_batch_render(mesh, cfg, space_mode="halo")(
                xyz, bundle, keys
            )
        dh = np.abs(np.asarray(single).astype(int) - np.asarray(halo_out).astype(int))
        margin = 12
        assert dh[:, :, margin:-margin, :].max() <= 1, dh[:, :, margin:-margin].max()

    def test_halo_burn_grid_aligned_at_seams(self):
        """The burn glow's low-res grid aligns to the GLOBAL frame under the
        halo path: seam rows agree with the unsharded render within one code
        (previously the per-shard grid could misalign by one low-res cell)."""
        bundle, cfg = _setup(
            h=96, w=96, halation=True, sharpness=True, highlight_burn=0.6
        )
        b, h, w = 4, 96, 96
        xyz = jnp.asarray(
            np.abs(np.random.default_rng(9).normal(0.3, 0.15, (b, 3, h, w))).astype(
                np.float32
            )
        )
        keys = jax.random.split(jax.random.PRNGKey(9), b)
        single = jax.jit(batch_render_fn(cfg))(xyz, bundle, keys)
        mesh = make_mesh(8, batch=4, space=2)
        with mesh:
            halo_out = sharded_batch_render(mesh, cfg, space_mode="halo")(
                xyz, bundle, keys
            )
        dh = np.abs(np.asarray(single).astype(int) - np.asarray(halo_out).astype(int))
        mid = dh[:, :, h // 2 - 8 : h // 2 + 8, :]
        assert mid.max() <= 1, mid.max()

    def test_mesh_shapes(self):
        mesh = make_mesh(8)
        assert mesh.shape == {"batch": 8, "space": 1}
        mesh = make_mesh(8, space=4)
        assert mesh.shape == {"batch": 2, "space": 4}

    def test_graft_entry_dryrun(self, monkeypatch):
        # Tiny frames here: the driver runs the production-size default
        # (1440x2160, minutes on the virtual CPU mesh); this test checks
        # the wiring on every CI run.
        monkeypatch.setenv("R2F_DRYRUN_HW", "128x192")
        import __graft_entry__ as g

        g.dryrun_multichip(8)

