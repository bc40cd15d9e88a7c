"""Catalog: named tables the SQL front end resolves FROM clauses against
— the port of ``dryad_tpu/sql/catalog.py``.

A :class:`Catalog` maps table names to one of

* a **store** path (``io/store.py`` partitioned store, written by either
  package — schema + row counts come from the manifest, so the static
  cost model's DTA2xx forecasts are seeded with REAL statistics),
* **inline host columns** (tests / small dimension tables),
* a **schema-only** declaration (offline EXPLAIN against a serialized
  catalog — ``python -m dryad_tpu_torch.sql`` and the golden plans plan
  real queries with no data and no device).

``fingerprint()`` hashes the full registration (names, schemas, store
paths, row counts, inline column content) and rides every ``sql_query``
event, so an event log identifies exactly which catalog a query
compiled against.  The JAX package's fingerprint of the same
registration is the same string.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Catalog", "CatalogTable", "SchemaContext",
           "SchemaOnlyTableError", "normalize_schema",
           "table_fingerprint"]


class SchemaOnlyTableError(ValueError):
    """Execution was requested over a table registered schema-only
    (no store path, no inline columns) — it supports offline EXPLAIN
    only.  Typed, so a caller can tell it from a failed run."""


def _norm_schema(schema: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Normalize a store-manifest / user schema to
    ``{col: {"kind": "str", "max_len": n} | {"kind": "num",
    "dtype": dtype_str}}``."""
    out: Dict[str, Dict[str, Any]] = {}
    for col, spec in schema.items():
        if isinstance(spec, str):
            spec = ({"kind": "str"} if spec == "str"
                    else {"kind": "num", "dtype": spec})
        if spec.get("kind") == "str":
            out[col] = {"kind": "str",
                        "max_len": int(spec.get("max_len", 64))}
        else:
            out[col] = {"kind": "num",
                        "dtype": str(spec.get("dtype", "int32"))}
    return out


def normalize_schema(schema: Dict[str, Any]
                     ) -> Dict[str, Dict[str, Any]]:
    """COLUMN-ORDER-INSENSITIVE normalized schema: ``_norm_schema``
    sorted by column name.  The ONE normalization both
    ``Catalog.fingerprint()`` and the semantic plan fingerprint
    (analysis/canon.py) hash, so a schema re-registered with its
    columns in a different order cannot produce a different
    fingerprint and orphan warm cache entries."""
    n = _norm_schema(schema)
    return {col: n[col] for col in sorted(n)}


def _inline_content_hash(t: "CatalogTable") -> str:
    """Content hash of an inline table's columns (column-order
    insensitive: iterates sorted names), computed once per registration:
    the columns are the catalog's own copies, never written
    (``register_columns``), and every submission to the job service
    reads it three times (the catalog and semantic fingerprints, the scan
    registry's key)."""
    if t._content_hash is None:
        t._content_hash = _hash_columns(t.columns)
    return t._content_hash


def _hash_columns(columns: Dict[str, Any]) -> str:
    h = hashlib.sha256()
    for col in sorted(columns):
        v = columns[col]
        h.update(col.encode())
        if isinstance(v, (list, tuple)):
            # every value then a NUL, hashed as one buffer (the JAX
            # package's per-value updates hash the same byte stream)
            if v:
                h.update(b"\x00".join(
                    x if isinstance(x, bytes) else str(x).encode()
                    for x in v))
                h.update(b"\x00")
        else:
            import numpy as np
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def table_fingerprint(t: "CatalogTable") -> str:
    """Per-table CONTENT fingerprint (16 hex chars): normalized schema
    + row stats + store path / inline column bytes.  Two catalog
    registrations with the same fingerprint serve the same rows, so a
    scan of one can be shared by queries over the other.  Shares its
    normalization with :meth:`Catalog.fingerprint`, so the two never
    disagree on column order."""
    d: Dict[str, Any] = {"kind": t.kind,
                         "schema": normalize_schema(t.schema),
                         "rows": t.rows}
    if t.path is not None:
        d["path"] = t.path
    if t.kind == "inline":
        d["content"] = _inline_content_hash(t)
    blob = json.dumps(d, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def sql_type_of(spec: Dict[str, Any]) -> str:
    """Binder-facing type name: "int" | "float" | "bool" | "str"."""
    if spec["kind"] == "str":
        return "str"
    dt = spec["dtype"]
    if dt.startswith("float"):
        return "float"
    if dt.startswith("bool"):
        return "bool"
    return "int"


class CatalogTable:
    def __init__(self, name: str, schema: Dict[str, Any],
                 path: Optional[str] = None,
                 columns: Optional[Dict[str, Any]] = None,
                 rows: int = 0, str_max_len: Optional[int] = None):
        self.name = name
        self.schema = _norm_schema(schema)
        self.path = path
        self.columns = columns
        self.rows = int(rows)
        self.str_max_len = str_max_len
        # an inline table's content hash, at its first use
        self._content_hash: Optional[str] = None

    @property
    def kind(self) -> str:
        if self.path is not None:
            return "store"
        return "inline" if self.columns is not None else "schema"

    def meta(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kind": self.kind, "schema": self.schema,
                             "rows": self.rows}
        if self.path is not None:
            d["path"] = self.path
        return d


class Catalog:
    """Mutable registry of tables; see module docstring."""

    def __init__(self):
        self.tables: Dict[str, CatalogTable] = {}

    # -- registration ------------------------------------------------------

    def register_store(self, name: str, path: str) -> "Catalog":
        """Register a persisted local ``io/store.py`` store; schema and
        row statistics come from its manifest."""
        from dryad_tpu_torch.io.store import store_meta
        meta = store_meta(path)
        self.tables[name] = CatalogTable(
            name, meta["schema"], path=path,
            rows=sum(meta.get("counts", ())))
        return self

    def register_columns(self, name: str, columns: Dict[str, Any],
                         str_max_len: Optional[int] = None) -> "Catalog":
        """Register in-memory host columns (numpy arrays / lists;
        lists of bytes|str are string columns).  The catalog keeps its
        own copy of every column (numeric ones read-only): a later write
        to the caller's arrays does not reach it."""
        import numpy as np
        schema: Dict[str, Any] = {}
        cols: Dict[str, Any] = {}
        rows = 0
        for col, v in columns.items():
            # numpy string/object arrays are string columns too — the
            # numeric branch would otherwise type them "int"
            if not isinstance(v, (list, tuple)) and \
                    getattr(getattr(v, "dtype", None), "kind", "") \
                    in ("U", "S", "O"):
                v = [x if isinstance(x, bytes) else str(x).encode()
                     for x in v]
            if isinstance(v, (list, tuple)) and (
                    len(v) == 0 or isinstance(v[0], (bytes, str))):
                ml = max((len(x if isinstance(x, bytes)
                              else str(x).encode()) for x in v),
                         default=1)
                schema[col] = {"kind": "str",
                               "max_len": str_max_len or max(ml, 1)}
                rows = len(v)
                cols[col] = list(v)
            else:
                # the catalog's own read-only copy: the content hash is
                # taken once, so the rows must not change under it
                arr = np.array(v)
                arr.setflags(write=False)
                schema[col] = {"kind": "num", "dtype": str(arr.dtype)}
                rows = arr.shape[0]
                cols[col] = arr
        self.tables[name] = CatalogTable(name, schema,
                                         columns=cols, rows=rows,
                                         str_max_len=str_max_len)
        return self

    def register_schema(self, name: str, schema: Dict[str, Any],
                        rows: int = 0) -> "Catalog":
        """Schema-only registration (offline EXPLAIN / golden plans)."""
        self.tables[name] = CatalogTable(name, schema, rows=rows)
        return self

    # -- lookup ------------------------------------------------------------

    def names(self) -> List[str]:
        return sorted(self.tables)

    def get(self, name: str) -> Optional[CatalogTable]:
        return self.tables.get(name)

    def watermark(self, name: str) -> int:
        """The append generation of a store-backed table, read from its
        live manifest (a refresh has something to scan when it is past
        the committed watermark)."""
        from dryad_tpu_torch.io.store import store_generation, store_meta
        return store_generation(store_meta(self._store_path(name)))

    def parts_since(self, name: str, watermark: int) -> List[int]:
        """Store partitions of ``name`` appended after ``watermark``: the
        delta an incremental refresh scans."""
        from dryad_tpu_torch.io.store import parts_since, store_meta
        return parts_since(store_meta(self._store_path(name)), watermark)

    def _store_path(self, name: str) -> str:
        t = self.tables[name]
        if t.kind != "store":
            raise ValueError(f"table {name!r} is {t.kind}-backed — only "
                             f"store tables carry an append watermark")
        return t.path

    def refresh_store(self, name: str) -> "Catalog":
        """Re-read a store table's manifest statistics (row counts grow
        as generations land; cost forecasts should see them)."""
        t = self.tables[name]
        if t.kind == "store":
            self.register_store(name, t.path)
        return self

    def fingerprint(self) -> str:
        """Hashes the full registration INCLUDING inline column
        CONTENT (two catalogs with equal schemas but different values
        must not collide).  Schemas hash through
        :func:`normalize_schema`, so re-registering a table with its
        columns reordered yields the SAME fingerprint."""
        meta = {}
        for n, t in self.tables.items():
            d = t.meta()
            d["schema"] = normalize_schema(t.schema)
            if t.kind == "inline":
                d["content"] = _inline_content_hash(t)
            meta[n] = d
        blob = json.dumps(meta, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # -- dataset construction ----------------------------------------------

    def dataset(self, ctx, name: str, loader=None):
        """Root Dataset for ``name`` under ``ctx`` (an api.Context or a
        :class:`SchemaContext`).  Returns ``(dataset, source
        data-handle)`` — the handle identity maps plan source slots back
        to table names (``sql.lower.source_tables``).

        ``loader`` (optional, ``name -> PData``) supplies the source data
        instead of a fresh store / columns read (one loaded PData shared
        by several queries over the same table).  Honored on an
        in-memory Context for tables below the auto-stream threshold; a
        streamed store keeps its own source."""
        from dryad_tpu_torch.api.dataset import Dataset
        from dryad_tpu_torch.plan import expr as E
        t = self.tables[name]
        if isinstance(ctx, SchemaContext):
            cap = max(1, -(-max(t.rows, 1) // ctx.nparts))
            node = E.Source(parents=(), data=_SchemaData(cap),
                            _npartitions=ctx.nparts)
            return Dataset(ctx, node), node.data
        if t.kind == "store":
            auto = ctx.config.ooc_auto_stream_rows
            if loader is not None and not (auto and t.rows >= auto):
                from dryad_tpu_torch.io.store import store_meta
                meta = store_meta(t.path)
                pmeta = meta.get("partitioning", {"kind": "none"})
                part = E.Partitioning(pmeta.get("kind", "none"),
                                      tuple(pmeta.get("keys", ())))
                if meta["npartitions"] != ctx.nparts:
                    part = E.Partitioning.none()
                ds = ctx.from_pdata(loader(name), partitioning=part)
            else:
                ds = ctx.from_store(t.path)
        elif t.kind == "inline":
            if loader is not None:
                ds = ctx.from_pdata(loader(name), host=dict(t.columns))
            else:
                ds = ctx.from_columns(dict(t.columns),
                                      str_max_len=t.str_max_len)
        else:
            raise SchemaOnlyTableError(
                f"table {name!r} is schema-only (no store path or "
                f"inline columns) — it supports offline EXPLAIN, not "
                f"execution")
        return ds, ds.node.data

    def load_pdata(self, mesh, name: str, config=None):
        """PData of ``name`` on ``mesh`` (a ``parallel.mesh.Mesh``), as
        ``dataset`` would load it: a re-bind of a plan's source slots
        reuses the plan JSON and re-reads only the data."""
        from dryad_tpu_torch.exec.data import pdata_from_host
        from dryad_tpu_torch.io.store import read_store
        t = self.tables[name]
        if t.kind == "store":
            verify = (config.store_verify_checksums
                      if config is not None else True)
            return read_store(t.path, mesh, verify=verify)
        if t.kind == "inline":
            # the default Context.from_columns applies, so a re-bound
            # batch has the shapes of the first load
            sml = t.str_max_len or (getattr(config, "string_max_len", 0)
                                    if config is not None else 0) or 64
            return pdata_from_host(dict(t.columns), mesh,
                                   str_max_len=sml)
        raise SchemaOnlyTableError(f"table {name!r} is schema-only")

    # -- (de)serialization -------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        """JSON form for ``save``/``load``.  Inline tables serialize
        their columns too (bytes ride as latin-1 strings — a LOSSLESS
        byte<->str round trip, unlike utf-8-with-replacement) plus
        their ``str_max_len``, so a saved catalog reloads to the SAME
        schema and fingerprint and stays executable."""
        out: Dict[str, Any] = {"tables": {}}
        for n, t in self.tables.items():
            d = t.meta()
            if t.kind == "inline":
                cols = {}
                for c, v in t.columns.items():
                    if isinstance(v, (list, tuple)):
                        cols[c] = [x.decode("latin1")
                                   if isinstance(x, bytes) else x
                                   for x in v]
                    else:
                        cols[c] = [x.item() if hasattr(x, "item") else x
                                   for x in v]
                d["columns"] = cols
                if t.str_max_len is not None:
                    d["str_max_len"] = t.str_max_len
            out["tables"][n] = d
        return out

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "Catalog":
        cat = cls()
        for n, d in obj.get("tables", {}).items():
            if d["kind"] == "store":
                # trust the serialized schema (the store may be remote/
                # unmounted at load time); the path re-resolves at
                # dataset() time
                cat.tables[n] = CatalogTable(n, d["schema"],
                                             path=d["path"],
                                             rows=d.get("rows", 0))
            elif d["kind"] == "inline" and "columns" in d:
                cols = {}
                for c, v in d["columns"].items():
                    if d["schema"].get(c, {}).get("kind") == "str":
                        cols[c] = [str(x).encode("latin1") for x in v]
                    else:
                        import numpy as np
                        cols[c] = np.asarray(
                            v, dtype=d["schema"][c]["dtype"])
                cat.register_columns(n, cols,
                                     str_max_len=d.get("str_max_len"))
            else:
                cat.register_schema(n, d["schema"],
                                    rows=d.get("rows", 0))
        return cat

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "Catalog":
        with open(path) as f:
            return cls.from_json(json.load(f))


class _SchemaData:
    """Source.data stand-in for schema-only planning: the planner needs
    only ``.capacity`` (plan/planner.py Source lowering)."""

    def __init__(self, capacity: int):
        self.capacity = capacity


class SchemaContext:
    """Context-shaped shim for OFFLINE planning: enough of
    api.Context's surface (nparts / hosts / levels / config / fn_table)
    to build and plan a query DAG with no device, no data and no
    executor — the golden plans and the offline EXPLAIN run on it.
    Terminals (collect / count / ...) are unavailable by construction
    (executor is None)."""

    def __init__(self, nparts: int = 8, config=None):
        from dryad_tpu_torch.utils.config import JobConfig
        self.nparts = nparts
        self.hosts = 1
        self.levels: Tuple[str, ...] = ()
        self.cluster = None
        self.local_debug = False
        self.mesh = None
        self.executor = None
        self.fn_table: Dict[str, Any] = {}
        self.config = config or JobConfig()
        self._event_log = None
