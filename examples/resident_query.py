#!/usr/bin/env python
"""Resident tables (packed planes in device memory) through the Query DSL.

Writes a small mixed-type file (strings, f64, ints, nullables), loads it as
a ResidentTable (bits/32 of the decoded size per column), and runs grouped
aggregates / filters / a join over it with the same Query API that drives
file scans.  Runs on the GPU, or on the CPU at a smaller size.
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import pyarrow as pa


def main():
    from strawboat.api import write_file
    from strawboat.codecs import WriteOptions
    from strawboat.exec import Query, col, load_resident

    import jax

    rng = np.random.default_rng(0)
    n = 4_000 if jax.default_backend() == "cpu" else 2_000_000
    region = np.array(["emea", "apac", "amer"])[rng.integers(0, 3, n)]
    status = np.array(["open", "closed"])[rng.integers(0, 2, n)]
    amount = np.round(rng.uniform(1.0, 900.0, n), 2)
    qty = rng.integers(1, 100, n)
    day = rng.integers(0, 365, n)
    t = pa.table(
        {
            "region": pa.array(region),
            "status": pa.array(status),
            "amount": pa.array(amount),
            "qty": pa.array(qty),
            "day": pa.array(day),
        }
    )
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "orders.str")
        write_file(path, t, options=WriteOptions(max_page_size=4096))
        rt = load_resident(
            path, tile=512 if jax.default_backend() == "cpu" else None
        )
        plane_bytes = sum(
            sum(w.size * 4 for w, _b in c.planes) for c in rt.columns.values()
        )
        print(f"resident: {n} rows, {plane_bytes/1e3:.0f} KB of packed planes")

        # grouped aggregate with a string-literal predicate
        res = (
            Query(rt)
            .filter((col("day") >= 90) & (col("status") == "open"))
            .group_by("region", num_groups=8)
            .agg(
                revenue=("sum", col("amount") * col("qty")),
                orders=("count", "qty"),
            )
            .run()
        )
        for i in range(int(res["n_groups"])):
            name = res["dict_region"][int(res["key_region"][i])].as_py()
            print(
                f"  {name}: revenue={float(res['revenue'][i]):.2f} "
                f"orders={int(res['orders'][i])}"
            )

        # LIMIT returns FILE-order rows (natural order is free: the plane
        # layout pre-permutes at load)
        head, _ = Query(rt).select("day", "qty").limit(3).run()
        print("  first 3 rows (file order):", np.asarray(head["day"].values),
              np.asarray(head["qty"].values))

        # numpy cross-check
        sel = (day >= 90) & (status == "open")
        for r in ("amer", "apac", "emea"):
            m = sel & (region == r)
            print(f"  numpy {r}: revenue={(amount[m]*qty[m]).sum():.2f} "
                  f"orders={int(m.sum())}")

        # nested columns (round 5): list<int> loads as a lengths plane +
        # child planes (fused per-row list_sum); struct<...> unnests to
        # `parent.field` columns the DSL queries directly.
        from strawboat.exec.resident import load_resident as _lr

        rng2 = np.random.default_rng(1)
        items = [
            list(map(int, rng2.integers(1, 9, int(k))))
            for k in rng2.integers(0, 5, 64)
        ]
        st = pa.struct(
            [pa.field("city", pa.string()), pa.field("zip", pa.int64())]
        )
        addr = pa.array(
            [{"city": ["sf", "nyc"][i % 2], "zip": 10000 + i} for i in range(64)],
            st,
        )
        t2 = pa.table(
            {
                "items": pa.array(items, pa.list_(pa.int64())),
                "addr": addr,
            },
            schema=pa.schema(
                [
                    pa.field("items", pa.list_(pa.int64()), nullable=False),
                    pa.field("addr", st, nullable=False),
                ]
            ),
        )
        p2 = os.path.join(d, "nested.str")
        write_file(p2, t2)
        rt2 = _lr(p2, tile=512)
        sums = np.asarray(rt2.list_sum("items"))[:64]
        assert sums.tolist() == [sum(x) for x in items]
        print("  list_sum(items) first 5:", sums[:5].tolist())
        res2 = (
            Query(rt2)
            .filter(col("addr.city") == "sf")
            .agg(n=("count", "addr.zip"))
            .run()
        )
        print("  addr.city == 'sf':", int(res2["n"]), "rows (expect 32)")
        # cast: to_arrow infers nullable fields; the DATA must match exactly
        assert rt2.to_arrow().cast(t2.schema).equals(t2)


if __name__ == "__main__":
    main()
