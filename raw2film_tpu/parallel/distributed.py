"""Multi-process (multi-host) batch rendering — the DCN tier.

The docs/scaling.md Tier-2 recipe as code: every process decodes ITS OWN
slice of the file list, assembles the global batch with
``jax.make_array_from_process_local_data`` (RAW bytes never cross the
network), and one ``sharded_batch_render`` call renders the global batch
over all processes' devices — collective-free on the batch axis, so DCN
carries nothing during compute.

Across hosts this runs over the cluster network; in CI it is validated end to end
with two localhost processes over the CPU collectives backend
(tests/test_distributed.py) — the process boundary, coordinator handshake,
global-array assembly, and per-process output scatter are identical.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def init_process(
    coordinator_address: str, num_processes: int, process_id: int
) -> None:
    """``jax.distributed.initialize`` wrapper (call before any backend
    touch; each process sees its local devices, jax.devices() the pod)."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def my_file_slice(files: list, process_id: int, num_processes: int) -> list:
    """Round-robin file assignment — each process decodes only its own
    shard (docs/scaling.md Tier 2 step 3)."""
    return list(files)[process_id::num_processes]


def distributed_batch_render(mesh, cfg, local_xyz, bundle, local_keys):
    """Render a globally-batched image set from per-process local shards.

    local_xyz: (B_local, 3, H, W) — this process's decoded images, where
    B_local = B_global / num_processes and the global batch order is
    process-major (process 0's images first). Returns this process's
    (B_local, 3, H, W) uint8 outputs.
    """
    from raw2film_tpu.parallel.mesh import sharded_batch_render

    nproc = jax.process_count()
    b_local = local_xyz.shape[0]
    b_global = b_local * nproc
    in_spec = P("batch", None, "space", None)
    xyz_g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, in_spec),
        np.asarray(local_xyz, np.float32),
        (b_global, *local_xyz.shape[1:]),
    )
    keys_g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("batch")),
        np.asarray(local_keys),
        (b_global, *np.asarray(local_keys).shape[1:]),
    )
    bundle_dev = jax.device_put(
        jax.tree.map(jnp.asarray, bundle), NamedSharding(mesh, P())
    )
    out = sharded_batch_render(mesh, cfg)(xyz_g, bundle_dev, keys_g)
    # Reassemble this process's rows from its addressable shards, honoring
    # BOTH sharded axes (batch and, when the mesh has one, space).
    shards = list(out.addressable_shards)
    b_starts = sorted({s.index[0].start or 0 for s in shards})
    assert b_starts, "process owns no shards"
    local = np.empty((b_local, *out.shape[1:]), out.dtype)
    covered = 0
    for s in shards:
        b0 = (s.index[0].start or 0) - b_starts[0]
        r0 = s.index[2].start or 0
        data = np.asarray(s.data)
        if not 0 <= b0 <= b_local - data.shape[0]:
            raise RuntimeError(
                "non-contiguous batch ownership: this process's shards span "
                f"batch rows {b_starts} for a local batch of {b_local} — "
                "order the mesh's batch axis process-major"
            )
        local[b0 : b0 + data.shape[0], :, r0 : r0 + data.shape[2], :] = data
        covered += data.size
    if covered != local.size:
        raise RuntimeError(
            f"addressable shards cover {covered} of {local.size} local "
            "elements — every process needs at least `space` local devices "
            "so its batch rows' full row extent is addressable"
        )
    return local
