"""TPC-H lineitem workload (BASELINE configs 4-5).

A dbgen-shaped generator (seeded, correct cardinalities/distributions at the
level that matters for codec selection and pruning: dates clustered, low-
cardinality utf8 flags, skewed quantities) plus full Q1 (all 8 aggregates,
utf8 group keys), Q6, and a Q3-shaped join expressed on the device engine.
Decimal columns are scaled-int64 (cents), the device's integer layout; money
aggregates therefore come back as exact integers in units of
cents (sum_base_price), cents/100 (sum_disc_price) and cents/10000
(sum_charge).
"""

from __future__ import annotations

import functools

from typing import Dict, Optional, Tuple

import numpy as np
import pyarrow as pa

ROWS_PER_SF = 6_000_000
EPOCH_DAYS = 2557  # 1992-01-01 .. 1998-12-31
Q1_DEFAULT_DELTA = 90

_RETURNFLAGS = np.array(["A", "N", "R"])
_SHIPMODES = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"])


def generate_lineitem(
    scale: float, seed: int = 0, rows: Optional[int] = None
) -> pa.Table:
    n = rows if rows is not None else int(ROWS_PER_SF * scale)
    rng = np.random.default_rng(seed)
    quantity = rng.integers(1, 51, n).astype(np.int64)  # 1..50
    extendedprice = (quantity * rng.integers(90000, 110001, n)).astype(np.int64)
    discount = rng.integers(0, 11, n).astype(np.int64)  # 0.00..0.10 (hundredths)
    tax = rng.integers(0, 9, n).astype(np.int64)
    # shipdate: days since 1992-01-01, clustered by order date over 7 years
    shipdate = np.sort(rng.integers(0, EPOCH_DAYS, n)).astype(np.int32)
    jitter = rng.integers(0, 122, n).astype(np.int32)
    shipdate = shipdate + jitter
    returnflag = rng.choice(_RETURNFLAGS, n, p=[0.25, 0.5, 0.25])
    linestatus = np.where(shipdate > 2190, "O", "F")
    shipmode = rng.choice(_SHIPMODES, n)
    orderkey = np.repeat(np.arange(max(n // 4, 1), dtype=np.int64), 4)[:n]
    suppkey = rng.integers(0, max(int(10000 * max(scale, 0.01)), 10), n).astype(
        np.int64
    )
    return pa.table(
        {
            "l_orderkey": pa.array(orderkey),
            "l_suppkey": pa.array(suppkey),
            "l_quantity": pa.array(quantity),
            "l_extendedprice": pa.array(extendedprice),
            "l_discount": pa.array(discount),
            "l_tax": pa.array(tax),
            "l_returnflag": pa.array(returnflag, type=pa.string()),
            "l_linestatus": pa.array(linestatus, type=pa.string()),
            "l_shipmode": pa.array(shipmode, type=pa.string()),
            "l_shipdate": pa.array(shipdate, type=pa.int32()),
        }
    )


# ---------------------------------------------------------------------------
# Q6


@functools.lru_cache(maxsize=1)
def _q6_fused():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def _run(sd, disc, qty, ep):
        d0, d1 = 731, 1096  # 1994-01-01 .. 1995-01-01, days since 1992-01-01
        m = (
            (sd >= d0)
            & (sd < d1)
            & (disc >= 5)
            & (disc <= 7)
            & (qty < 24)
        )
        return jnp.sum(jnp.where(m, ep * disc, 0))

    return _run


def q6(table):
    """TPC-H Q6: revenue from discounted small shipments in 1994.

    revenue = sum(extendedprice * discount) where shipdate in [1994, 1995),
    discount in [5, 7] (hundredths), quantity < 24.  Predicate + aggregate
    fuse into one executable (one dispatch instead of one per op).
    """
    return _q6_fused()(
        table["l_shipdate"].values,
        table["l_discount"].values,
        table["l_quantity"].values,
        table["l_extendedprice"].values,
    )


def q6_pruning_predicates():
    from ..exec.pruning import Comparison

    return [Comparison("l_shipdate", "ge", 731), Comparison("l_shipdate", "lt", 1096)]


def q6_numpy_reference(table: pa.Table) -> int:
    sd = table.column("l_shipdate").to_numpy()
    disc = table.column("l_discount").to_numpy()
    qty = table.column("l_quantity").to_numpy()
    ep = table.column("l_extendedprice").to_numpy()
    m = (sd >= 731) & (sd < 1096) & (disc >= 5) & (disc <= 7) & (qty < 24)
    return int((ep[m] * disc[m]).sum())


# ---------------------------------------------------------------------------
# Q1 — full pricing summary (all 8 aggregates, utf8 group keys)

_Q1_AGG_NAMES = (
    "sum_qty",
    "sum_base_price",
    "sum_disc_price",
    "sum_charge",
    "avg_qty",
    "avg_price",
    "avg_disc",
    "count_order",
)


def _q1_aggs():
    from ..exec import col

    disc_price = col("l_extendedprice") * (100 - col("l_discount"))
    charge = disc_price * (100 + col("l_tax"))
    return {
        "sum_qty": ("sum", "l_quantity"),
        "sum_base_price": ("sum", "l_extendedprice"),
        "sum_disc_price": ("sum", disc_price),
        "sum_charge": ("sum", charge),
        "avg_qty": ("avg", "l_quantity"),
        "avg_price": ("avg", "l_extendedprice"),
        "avg_disc": ("avg", "l_discount"),
        "count_order": ("count", "l_quantity"),
    }


def _decode_key_strings(col_, codes: np.ndarray) -> list:
    d = col_.dictionary
    out = []
    for c in codes:
        v = d[int(c)].as_py()
        out.append(v.decode() if isinstance(v, bytes) else v)
    return out


def _q1_rows_to_table(flags, statuses, cols: Dict[str, np.ndarray]) -> pa.Table:
    order = sorted(range(len(flags)), key=lambda i: (flags[i], statuses[i]))
    data = {
        "l_returnflag": pa.array([flags[i] for i in order], pa.string()),
        "l_linestatus": pa.array([statuses[i] for i in order], pa.string()),
    }
    for name in _Q1_AGG_NAMES:
        v = cols[name]
        data[name] = pa.array([v[i] for i in order])
    return pa.table(data)


def q1(table, delta_days: int = Q1_DEFAULT_DELTA) -> pa.Table:
    """TPC-H Q1 via the sort/segment hash aggregate, utf8 keys.

    Returns an arrow table ordered by (l_returnflag, l_linestatus) with all
    8 aggregates.
    """
    from ..exec import col, hash_aggregate

    cutoff = EPOCH_DAYS - delta_days
    mask = (col("l_shipdate") <= cutoff).mask(table)
    res = hash_aggregate(
        table,
        keys=["l_returnflag", "l_linestatus"],
        aggs=_q1_aggs(),
        num_groups=16,
        mask=mask,
    )
    n = int(res["n_groups"])
    flags = _decode_key_strings(
        table["l_returnflag"], np.asarray(res["key_l_returnflag"])[:n]
    )
    statuses = _decode_key_strings(
        table["l_linestatus"], np.asarray(res["key_l_linestatus"])[:n]
    )
    cols = {name: np.asarray(res[name])[:n] for name in _Q1_AGG_NAMES}
    return _q1_rows_to_table(flags, statuses, cols)


@functools.lru_cache(maxsize=8)
def _q1_dense_fused(n_ls: int, ng: int):
    """One jitted executable for all Q1 dense aggregates (cached per shape —
    a fresh jit wrapper per call would re-trace every time)."""
    import jax
    import jax.numpy as jnp

    from ..exec.aggregate import dense_group_sum

    @jax.jit
    def _all(rf_codes, ls_codes, qty, ep, disc, tax, mask):
        code = rf_codes * n_ls + ls_codes
        disc_price = ep * (jnp.int64(100) - disc)
        charge = disc_price * (jnp.int64(100) + tax)
        sum_qty, cnt = dense_group_sum(code, qty, ng, mask)
        sum_base, _ = dense_group_sum(code, ep, ng, mask)
        sum_dp, _ = dense_group_sum(code, disc_price, ng, mask)
        sum_ch, _ = dense_group_sum(code, charge, ng, mask)
        sum_disc, _ = dense_group_sum(code, disc, ng, mask)
        return jnp.stack([sum_qty, sum_base, sum_dp, sum_ch, sum_disc, cnt])

    return _all


def q1_dense(table, delta_days: int = Q1_DEFAULT_DELTA) -> pa.Table:
    """TPC-H Q1 on the dense-code matmul path.

    The composite key (returnflag, linestatus) is 6 dense dictionary-code
    values, so per-group sums become one-hot matmuls (``dense_group_sum``) —
    no sort pass.  All five sums + the count compute inside ONE jitted call
    and come back in ONE fetch.  Same result table as
    :func:`q1`.
    """
    import jax

    from ..exec import col
    from ..exec.aggregate import dense_group_sum

    cutoff = EPOCH_DAYS - delta_days
    mask = (col("l_shipdate") <= cutoff).mask(table)
    rf = table["l_returnflag"]
    ls = table["l_linestatus"]
    n_rf = len(rf.dictionary)
    n_ls = len(ls.dictionary)
    ng = n_rf * n_ls

    stacked = np.asarray(
        _q1_dense_fused(n_ls, ng)(
            rf.values,
            ls.values,
            table["l_quantity"].values,
            table["l_extendedprice"].values,
            table["l_discount"].values,
            table["l_tax"].values,
            mask,
        )
    )
    sum_qty, sum_base, sum_dp, sum_ch, sum_disc, cnt = stacked
    cnt_np = np.asarray(cnt)
    live = np.flatnonzero(cnt_np > 0)
    flags = _decode_key_strings(rf, live // n_ls)
    statuses = _decode_key_strings(ls, live % n_ls)
    cnt_live = cnt_np[live].astype(np.float64)
    cols = {
        "sum_qty": np.asarray(sum_qty)[live],
        "sum_base_price": np.asarray(sum_base)[live],
        "sum_disc_price": np.asarray(sum_dp)[live],
        "sum_charge": np.asarray(sum_ch)[live],
        "avg_qty": np.asarray(sum_qty)[live] / cnt_live,
        "avg_price": np.asarray(sum_base)[live] / cnt_live,
        "avg_disc": np.asarray(sum_disc)[live] / cnt_live,
        "count_order": cnt_np[live],
    }
    return _q1_rows_to_table(flags, statuses, cols)


def q1_query(path: str, delta_days: int = Q1_DEFAULT_DELTA):
    """Q1 through the fluent Query API with ORDER BY (pushdown + pruning +
    lexical key ordering all engage)."""
    from ..exec import Query, col

    cutoff = EPOCH_DAYS - delta_days
    return (
        Query(path)
        .filter(col("l_shipdate") <= cutoff)
        .group_by("l_returnflag", "l_linestatus", num_groups=16)
        .agg(**_q1_aggs())
        .order_by("key_l_returnflag", "key_l_linestatus")
        .run()
    )


def q1_numpy_reference(
    table: pa.Table, delta_days: int = Q1_DEFAULT_DELTA
) -> Dict[Tuple[str, str], Dict[str, float]]:
    sd = table.column("l_shipdate").to_numpy()
    rf = np.asarray(table.column("l_returnflag").to_pylist())
    ls = np.asarray(table.column("l_linestatus").to_pylist())
    qty = table.column("l_quantity").to_numpy()
    ep = table.column("l_extendedprice").to_numpy()
    disc = table.column("l_discount").to_numpy()
    tax = table.column("l_tax").to_numpy()
    m = sd <= (EPOCH_DAYS - delta_days)
    out = {}
    for f in np.unique(rf):
        for s in np.unique(ls):
            g = m & (rf == f) & (ls == s)
            n = int(g.sum())
            if not n:
                continue
            dp = ep[g] * (100 - disc[g])
            ch = dp * (100 + tax[g])
            out[(str(f), str(s))] = {
                "sum_qty": int(qty[g].sum()),
                "sum_base_price": int(ep[g].sum()),
                "sum_disc_price": int(dp.sum()),
                "sum_charge": int(ch.sum()),
                "avg_qty": float(qty[g].mean()),
                "avg_price": float(ep[g].mean()),
                "avg_disc": float(disc[g].mean()),
                "count_order": n,
            }
    return out


# ---------------------------------------------------------------------------
# orders + Q3-shaped join


def generate_orders(scale: float, seed: int = 1, rows: Optional[int] = None) -> pa.Table:
    """Orders table (1.5M rows/SF): orderkey aligned with lineitem's."""
    n = rows if rows is not None else int(1_500_000 * scale)
    rng = np.random.default_rng(seed)
    orderkey = np.arange(n, dtype=np.int64)
    custkey = rng.integers(0, max(int(150_000 * max(scale, 0.01)), 10), n).astype(np.int64)
    orderdate = rng.integers(0, EPOCH_DAYS - 151, n).astype(np.int32)
    # order priority segment: low-cardinality int (1..5)
    priority = rng.integers(1, 6, n).astype(np.int64)
    return pa.table(
        {
            "o_orderkey": pa.array(orderkey),
            "o_custkey": pa.array(custkey),
            "o_orderdate": pa.array(orderdate, type=pa.int32()),
            "o_orderpriority": pa.array(priority),
        }
    )


def q3_like(lineitem, orders, date_cut: int = 1000, num_groups: int = 8192):
    """Q3-shaped query: join lineitem→orders on orderkey, filter order date,
    group revenue by order priority.

    Exercises the searchsorted hash join + grouped aggregate at fact-table
    scale (orders is the unique-key build side).
    """
    import jax.numpy as jnp

    from ..exec import hash_join
    from ..exec.aggregate import grouped_aggregate

    pi, bi, valid = hash_join(lineitem, orders, on=("l_orderkey", "o_orderkey"))
    odate = orders["o_orderdate"].values[bi]
    valid = jnp.logical_and(valid, odate < date_cut)
    revenue = (
        lineitem["l_extendedprice"].values[pi]
        * (jnp.int64(100) - lineitem["l_discount"].values[pi])
    )
    prio = orders["o_orderpriority"].values[bi]
    uniq, n_groups, rep, (total,) = grouped_aggregate(
        (prio,), (revenue,), valid, num_groups, (("sum", 0),)
    )
    return uniq, n_groups, total
