"""Multi-file dataset scan: many ``.str`` files as ONE logical device table.

No reference counterpart — the reference is a single-file format library
(`/root/reference/src/read/reader.rs`), and its production consumer
(Databend) layers exactly this on top: a table is many immutable files on
object storage, scanned together.  This module is that layer, on the device:

* **File-level pruning** touches only a file's footer + in-band zone block
  (`pruning.read_zones` reads the tail, never the data pages) — a file whose
  zones prove no page can match is skipped entirely, the object-store
  analogue of the reference's page-skip `Iterator::nth` (reader.rs:91-116)
  one level up.
* Surviving files scan with the usual page-level pruning (`scan_file`), and
  columns **concatenate on device** — one `jnp.concatenate` per column, not
  per page.
* Dictionary-coded string columns merge through the same KB-scale pool
  dedup the distributed layer uses (`parallel.dist_scan._merge_dictionaries`):
  per-file dictionaries union host-side, per-file codes remap with one
  device gather; row bytes never re-encode.
"""

from __future__ import annotations

import glob as _glob

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import pyarrow as pa

from ..errors import NotYetImplementedError, OutOfSpecError
from .scan import DeviceColumn, DeviceListColumn, DeviceTable, scan_file


def resolve_paths(paths: Union[str, Sequence[str]]) -> List[str]:
    """A glob pattern or an explicit list → sorted concrete paths."""
    if isinstance(paths, str):
        out = sorted(_glob.glob(paths))
        if not out:
            raise OutOfSpecError(f"dataset glob matched no files: {paths!r}")
        return out
    out = list(paths)
    if not out:
        raise OutOfSpecError("dataset file list is empty")
    return out


def file_may_match(path: str, predicates: Optional[Sequence]) -> bool:
    """Footer-only check: can ANY page of ``path`` satisfy ``predicates``?

    Reads the zone block from the file tail (no data pages).  Files without
    zones conservatively match.
    """
    if not predicates:
        return True
    from .pruning import prune_pages, read_zones

    zones = read_zones(path)
    if not zones:
        return True
    n_pages = max(len(z.pages) for z in zones.values())
    keep = prune_pages(zones, predicates, n_pages)
    return bool(keep.any())


def _concat_validity(parts: List[DeviceColumn]):
    """Concatenated validity, or None when every part is all-valid."""
    import jax.numpy as jnp

    if all(p.validity is None for p in parts):
        return None
    vs = [
        p.validity
        if p.validity is not None
        else jnp.ones(len(p), dtype=jnp.bool_)
        for p in parts
    ]
    return jnp.concatenate(vs)


def concat_device_columns(name: str, parts: List[DeviceColumn]) -> DeviceColumn:
    """Concatenate one column's per-file pieces on device.

    Dict-coded parts merge dictionaries host-side (pool dedup) and remap
    codes with one device gather per part.  List columns are not yet
    concatenable across files — they raise, never silently drop.
    """
    import jax.numpy as jnp

    if len(parts) == 1:
        return parts[0]
    if any(isinstance(p, DeviceListColumn) for p in parts):
        raise NotYetImplementedError(
            f"dataset concat of list column {name!r} (scan files separately)"
        )
    dtypes = {str(p.dtype) for p in parts}
    if len(dtypes) > 1:
        raise OutOfSpecError(f"column {name!r} type differs across files: {dtypes}")
    validity = _concat_validity(parts)
    if any(p.dictionary is not None for p in parts):
        if not all(p.dictionary is not None for p in parts):
            # remapping plain values through a dictionary translation table
            # would clamp out-of-range indices into silent garbage
            raise OutOfSpecError(
                f"column {name!r} mixes dictionary and plain encodings "
                "across dataset parts"
            )
        from ..parallel.dist_scan import _merge_dictionaries

        gdict, tables = _merge_dictionaries([p.dictionary for p in parts])
        vals = jnp.concatenate(
            [
                jnp.asarray(t, dtype=jnp.int32)[p.values.astype(jnp.int32)]
                for p, t in zip(parts, tables)
            ]
        )
        return DeviceColumn(name, parts[0].dtype, vals, validity, dictionary=gdict)
    values = jnp.concatenate([p.values for p in parts])
    host_exact = None
    if all(p.host_exact is not None for p in parts):
        host_exact = np.concatenate([p.host_exact for p in parts])
    return DeviceColumn(
        name, parts[0].dtype, values, validity, host_exact=host_exact
    )


def concat_device_tables(tables: List[DeviceTable]) -> DeviceTable:
    """Row-wise concatenation of per-file device tables (schemas must agree)."""
    if not tables:
        return DeviceTable({}, 0)
    names = list(tables[0].columns)
    for t in tables[1:]:
        if list(t.columns) != names:
            raise OutOfSpecError(
                f"dataset files disagree on columns: {names} vs {list(t.columns)}"
            )
    out: Dict[str, DeviceColumn] = {}
    for name in names:
        out[name] = concat_device_columns(name, [t.columns[name] for t in tables])
    return DeviceTable(out, sum(t.num_rows for t in tables))


def scan_dataset(
    paths: Union[str, Sequence[str]],
    columns: Optional[Sequence[str]] = None,
    predicates: Optional[Sequence] = None,
) -> DeviceTable:
    """Scan a multi-file dataset into one device table.

    ``paths``: a glob pattern (``"part-*.str"``) or explicit list.  Files
    whose zone blocks prove no match are skipped footer-only; the rest scan
    with page-level pruning and concatenate on device.
    """
    concrete = resolve_paths(paths)
    survivors = [p for p in concrete if file_may_match(p, predicates)]
    parts = [
        scan_file(p, columns=columns, predicates=predicates) for p in survivors
    ]
    parts = [t for t in parts if t.num_rows > 0]
    if not parts:
        # recover the schema cheaply: re-scan the first file WITH the
        # predicates — its pages all prune (file_may_match already proved no
        # zone can match), so no data page decodes and the result is the
        # 0-row table with the right columns (incl. empty list columns,
        # consistent with scan_file's own empty result)
        return scan_file(concrete[0], columns=columns, predicates=predicates)
    return concat_device_tables(parts)


def write_dataset(
    directory: str,
    data: pa.Table,
    rows_per_file: int,
    options=None,
    prefix: str = "part",
) -> List[str]:
    """Split ``data`` into ``rows_per_file``-row part files under ``directory``.

    The write side of the dataset layer: each part is an ordinary standalone
    ``.str`` file (own footer + in-band zone block), so any subset of parts
    is a valid dataset and immutable parts can be rewritten independently —
    the object-store layout the scan side's footer-only pruning is built
    for.  Returns the written paths (``part-00000.str`` …).
    """
    import os

    from ..write.writer import write_file

    if rows_per_file <= 0:
        raise OutOfSpecError("rows_per_file must be positive")
    os.makedirs(directory, exist_ok=True)
    paths = []
    n = data.num_rows
    for i, off in enumerate(range(0, max(n, 1), rows_per_file)):
        part = data.slice(off, min(rows_per_file, n - off)) if n else data
        p = os.path.join(directory, f"{prefix}-{i:05d}.str")
        write_file(p, part.combine_chunks(), options=options)
        paths.append(p)
        if n == 0:
            break
    return paths


def iter_dataset_chunks(
    paths: Union[str, Sequence[str]],
    chunk_pages: int,
    columns: Optional[Sequence[str]] = None,
    predicates: Optional[Sequence] = None,
):
    """Stream a dataset as DeviceTable chunks (files in order, then pages).

    The multi-file extension of :func:`scan_chunks` for datasets larger than
    HBM; file-level pruning applies before any chunking.
    """
    from .scan import scan_chunks

    for p in resolve_paths(paths):
        if not file_may_match(p, predicates):
            continue
        yield from scan_chunks(
            p, chunk_pages, columns=columns, predicates=predicates
        )


# ---------------------------------------------------------------------------
# Manifest: object-store planning without touching part footers.
#
# The reference exports its column metas as JSON for external catalogs
# (/root/reference/examples/strawboat_write.rs:45-52); a dataset manifest is
# that idea one level up: per part, the row count and FILE-level zone fold
# (min/max/null_count per column), so the planner prunes parts with zero
# reads.  The manifest is advisory — scanning falls back to per-file footer
# checks for parts it doesn't list.


def dataset_manifest(paths: Union[str, Sequence[str]]) -> dict:
    """Build a manifest dict for the given parts (reads footers once)."""
    from ..read.reader import read_meta
    from .pruning import read_zones

    parts = []
    for p in resolve_paths(paths):
        with open(p, "rb") as f:
            metas = read_meta(f)
        n_rows = int(sum(pg.num_values for pg in metas[0].pages))
        zones = read_zones(p)
        cols = {}
        if zones:
            for name, cz in zones.items():
                mins = [z.min for z in cz.pages if z.min is not None]
                maxs = [z.max for z in cz.pages if z.max is not None]
                if mins:
                    cols[name] = {
                        "min": min(mins),
                        "max": max(maxs),
                        "null_count": int(sum(z.null_count for z in cz.pages)),
                        "kind": cz.kind or "i",
                    }
        parts.append({"path": p, "num_rows": n_rows, "columns": cols})
    return {"version": 1, "parts": parts}


def write_manifest(manifest: dict, path: str) -> None:
    import json

    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, default=int)


def load_manifest(path: str) -> dict:
    import json

    with open(path) as f:
        return json.load(f)


def _part_may_match(entry: dict, predicates: Optional[Sequence]) -> bool:
    """Manifest-level prune: conservative 3-valued check per predicate."""
    if not predicates:
        return True
    for pred in predicates:
        c = entry.get("columns", {}).get(pred.column)
        if c is None:
            continue
        lo, hi, v = c["min"], c["max"], pred.value
        op = pred.op
        if op == "eq" and (v < lo or v > hi):
            return False
        if op in ("lt",) and not (lo < v):
            return False
        if op in ("le",) and not (lo <= v):
            return False
        if op in ("gt",) and not (hi > v):
            return False
        if op in ("ge",) and not (hi >= v):
            return False
    return True


def scan_dataset_with_manifest(
    manifest: dict,
    columns: Optional[Sequence[str]] = None,
    predicates: Optional[Sequence] = None,
) -> DeviceTable:
    """Like :func:`scan_dataset` but parts prune from the manifest with ZERO
    file reads; surviving parts still page-prune from their own zones."""
    survivors = [
        e["path"] for e in manifest["parts"] if _part_may_match(e, predicates)
    ]
    if not survivors:
        # scan_dataset's own footer pruning on the first part yields the
        # 0-row table with the correct schema
        survivors = [manifest["parts"][0]["path"]]
    return scan_dataset(survivors, columns=columns, predicates=predicates)


def compact_dataset(
    paths: Union[str, Sequence[str]],
    out_dir: str,
    rows_per_file: int,
    options=None,
    prefix: str = "part",
) -> List[str]:
    """Rewrite many small parts into balanced larger ones (or vice versa).

    Reads through the device scan (exact arrow rebuild, incl. bit-exact f64
    via ``host_exact``), writes standalone parts with fresh zone blocks.
    """
    dt = scan_dataset(paths)
    return write_dataset(
        out_dir, dt.to_arrow(), rows_per_file, options=options, prefix=prefix
    )
