#!/usr/bin/env python
"""Distributed scan→shuffle→aggregate scaling harness (BASELINE config 5).

Runs the two-stage distributed hash aggregate over an n-device mesh and
reports rows/s at each device count plus scaling efficiency.  By default the
mesh is 8 virtual CPU devices, which checks the code path but cannot scale;
``--gpu`` runs it over the machine's GPUs.

Usage: python examples/dist_bench.py [rows_per_shard] [max_devices]
"""

import os
import sys
import time

sys.path.insert(0, ".")

# a scaling sweep needs a multi-device mesh: default to an 8-device virtual
# CPU mesh (pass --gpu to use the machine's GPUs)
if "--gpu" not in sys.argv:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        )
    os.environ["JAX_PLATFORMS"] = "cpu"


def main() -> int:
    import jax

    if "--gpu" not in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from strawboat.parallel import distributed_aggregate, make_mesh

    rows_per_shard = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 18
    max_dev = int(sys.argv[2]) if len(sys.argv) > 2 else jax.device_count()

    rng = np.random.default_rng(0)
    results = {}
    for n_dev in [d for d in (1, 2, 4, 8, 16) if d <= max_dev]:
        mesh = make_mesh(n_dev)
        n = rows_per_shard * n_dev
        key = jnp.asarray(rng.integers(0, 1000, n).astype(np.int64))
        val = jnp.asarray(rng.integers(0, 10**6, n).astype(np.int64))
        sh = NamedSharding(mesh, P("shards"))
        key = jax.device_put(key, sh)
        val = jax.device_put(val, sh)

        def run():
            res = distributed_aggregate(
                mesh, "shards", key, {"total": ("sum", val)}, num_groups=2048
            )
            return float(np.asarray(res["total"]).sum())

        run()  # warm/compile
        t0 = time.perf_counter()
        iters = 3
        for _ in range(iters):
            run()
        dt = (time.perf_counter() - t0) / iters
        rps = n / dt
        results[n_dev] = rps
        base = results[1] if 1 in results else rps
        eff = rps / (n_dev * base) if base else 0.0
        print(
            f"devices={n_dev:>2} rows={n:>9} {dt * 1e3:8.1f} ms "
            f"{rps / 1e6:8.1f} Mrows/s  scaling-eff={eff:.2%}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
