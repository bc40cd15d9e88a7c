"""The partitioned store on an S3-compatible object store — the port of
``dryad_tpu/io/s3_store.py``.

The local store's layout (``io/store.py``: one part of concatenated
column segments per partition, raw or gzip, fnv64-checksummed, and a
``meta.json``) as objects ``<prefix>/<gen>/part-00000.bin`` ... and
``<prefix>/meta.json``.  S3 has no atomic rename, so ``meta.json`` is
written LAST and is the commit: its ``generation`` (a fresh random
subprefix per write) names the parts, so a reader holding the previous
manifest keeps reading the previous write's parts while an overwrite
runs.  After the commit every generation but the new one and the one it
superseded is deleted, best effort.  The layout is the JAX package's, so
either package reads the other's stores.
"""

from __future__ import annotations

import gzip
import json
import uuid
from typing import Any, Dict, List, Optional

from dryad_tpu_torch.io.s3 import S3Client, S3Config, parse_s3_url

__all__ = ["s3_write_store", "s3_store_meta", "s3_read_part_segments",
           "s3_read_part_views", "write_partition_objects", "s3_client"]

_CLIENT: Optional[S3Client] = None


def s3_client(config: Optional[S3Config] = None) -> S3Client:
    """The process-default client (environment-configured), or a new
    one for ``config``."""
    global _CLIENT
    if config is not None:
        return S3Client(config)
    if _CLIENT is None:
        _CLIENT = S3Client()
    return _CLIENT


def _part_key(prefix: str, p: int, gen: str = "") -> str:
    """A part's object key under its write generation's subprefix (an
    empty ``gen``: a store written before generations)."""
    g = f"{gen}/" if gen else ""
    return f"{prefix.rstrip('/')}/{g}part-{p:05d}.bin"


def s3_store_meta(url: str, client: Optional[S3Client] = None
                  ) -> Dict[str, Any]:
    c = client or s3_client()
    bucket, prefix = parse_s3_url(url)
    return json.loads(c.get_object(bucket,
                                   prefix.rstrip("/") + "/meta.json"))


def s3_write_store(url: str, pd, partitioning=None, compression=None,
                   client: Optional[S3Client] = None) -> None:
    """``write_store`` for ``s3://`` paths: the same segments, checksums
    and manifest, parts uploaded in parallel, the manifest last."""
    from dryad_tpu_torch.io.fnv import checksum_segments
    from dryad_tpu_torch.io.store import (_parallel, build_meta,
                                          pdata_part_segments,
                                          pdata_schema, segments_blob)

    if compression not in (None, "gzip"):
        raise ValueError(f"unknown compression {compression!r}")
    c = client or s3_client()
    bucket, prefix = parse_s3_url(url)
    schema = pdata_schema(pd)
    segments, counts = pdata_part_segments(pd, schema)
    gen = uuid.uuid4().hex[:12]

    def upload(job):
        p, segs = job
        c.put_object(bucket, _part_key(prefix, p, gen),
                     segments_blob(segs, compression))
        return "%016x" % checksum_segments(segs)

    checksums = _parallel(upload, list(enumerate(segments)))
    meta = build_meta(schema, counts, checksums,
                      partitioning=partitioning, compression=compression,
                      capacity=pd.capacity)
    meta["generation"] = gen
    # the superseded manifest names the generation a reader may still
    # hold: it survives this write, anything older is garbage
    prev_gen = None
    try:
        prev = json.loads(c.get_object(bucket,
                                       prefix.rstrip("/") + "/meta.json"))
        prev_gen = prev.get("generation", "")
    except Exception:
        pass
    c.put_object(bucket, prefix.rstrip("/") + "/meta.json",
                 json.dumps(meta, indent=1).encode())
    try:
        keep = {gen, prev_gen or ""}
        base = prefix.rstrip("/") + "/"
        # list first, delete after: deleting under a live paginator
        # shifts its offsets and skips keys
        for key, _sz in list(c.list_objects(bucket, base)):
            rel = key[len(base):]
            if "/" in rel and rel.endswith(".bin"):
                if rel.split("/", 1)[0] not in keep:
                    c.delete_object(bucket, key)
            elif rel.startswith("part-") and rel.endswith(".bin") \
                    and "" not in keep:
                c.delete_object(bucket, key)   # a pre-generation part
    except Exception:
        pass   # the collection never fails a committed write


def write_partition_objects(url: str, schema, blobs: List[bytes],
                            part_ids: List[int], gen: str = "",
                            client: Optional[S3Client] = None) -> None:
    """Upload raw partition blobs under generation ``gen``; whoever
    commits ``meta.json`` afterwards must record the same ``gen``."""
    c = client or s3_client()
    bucket, prefix = parse_s3_url(url)
    for p, blob in zip(part_ids, blobs):
        c.put_object(bucket, _part_key(prefix, p, gen), blob)


def s3_read_part_segments(url: str, meta: Dict[str, Any], p: int,
                          client: Optional[S3Client] = None) -> list:
    """One partition's column segments, decompressed and filled."""
    return s3_read_part_views(url, meta, p, client=client)[0]


def s3_read_part_views(url: str, meta: Dict[str, Any], p: int,
                       client: Optional[S3Client] = None):
    """(segments, column views) of one partition, as
    ``io/store._alloc_part`` lays them out, filled from its object."""
    from dryad_tpu_torch.io.store import _alloc_part, fill_segments

    c = client or s3_client()
    bucket, prefix = parse_s3_url(url)
    segs, cols = _alloc_part(meta["schema"], int(meta["counts"][p]))
    data = c.get_object(bucket, _part_key(prefix, p,
                                          meta.get("generation", "")))
    if meta.get("compression") == "gzip":
        data = gzip.decompress(data)
    fill_segments(segs, data, "s3 object")
    return segs, cols
