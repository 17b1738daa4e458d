"""Index persistence: directory format with pinned dtypes.

Mirrors the reference's layout (reference: src/serialize.rs:33-209):
``meta`` JSON with layer_count + build parameters, per-layer
``layer.meta.{n}`` JSON and raw ``layer.nodes.{n}`` / ``layer.neighbors.{n}``
dumps (numbered from the *bottom*), plus a ``comparator/`` directory for the
vector store.  Unlike the reference's native-endian ``usize`` memory dumps
(src/serialize.rs:96-121), all arrays are little-endian int32/float32 — the
format is portable across hosts.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from parallel_hnsw.graph import DenseSource, Layer, PqSource, Source
from parallel_hnsw.index import Hnsw
from parallel_hnsw.ops.distance import Metric
from parallel_hnsw.params import build_params_from_dict, params_to_dict

FORMAT_VERSION = 1


class SerializationError(Exception):
    pass


class IndexNotFound(SerializationError):
    """Missing comparator directory (reference: serialize.rs:143-146)."""


def _write_array(path: Path, arr: np.ndarray, dtype: str) -> None:
    np.ascontiguousarray(arr.astype(np.dtype(dtype).newbyteorder("<"))).tofile(path)


def _read_array(path: Path, dtype: str, shape) -> np.ndarray:
    arr = np.fromfile(path, dtype=np.dtype(dtype).newbyteorder("<"))
    return arr.reshape(shape)


# -- source (comparator) serialization --------------------------------------


def serialize_source(source: Source, path: Union[str, Path]) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if isinstance(source, DenseSource):
        vec = np.asarray(source.vectors, np.float32)
        meta = {"kind": "dense", "count": vec.shape[0], "dim": vec.shape[1]}
        _write_array(path / "vectors", vec, "float32")
    elif isinstance(source, PqSource):
        code_dtype = str(np.asarray(source.codes).dtype)
        codes = np.asarray(source.codes)
        book = np.asarray(source.codebook, np.float32)
        meta = {
            "kind": "pq",
            "count": codes.shape[0],
            "nsub": codes.shape[1],
            "code_dtype": code_dtype,
            "codebook_shape": list(book.shape),  # [K, dsub] shared or [Q, K, dsub]
        }
        _write_array(path / "codes", codes, code_dtype)
        _write_array(path / "codebook", book, "float32")
    else:
        raise SerializationError(f"unknown source type {type(source)}")
    (path / "meta").write_text(json.dumps(meta))


def deserialize_source(path: Union[str, Path]) -> Source:
    path = Path(path)
    meta = json.loads((path / "meta").read_text())
    if meta["kind"] == "dense":
        vec = _read_array(path / "vectors", "float32", (meta["count"], meta["dim"]))
        return DenseSource(vectors=jnp.asarray(vec))
    if meta["kind"] == "pq":
        dt = meta.get("code_dtype", "int32")
        codes = _read_array(path / "codes", dt, (meta["count"], meta["nsub"]))
        book = _read_array(path / "codebook", "float32", tuple(meta["codebook_shape"]))
        return PqSource(codes=jnp.asarray(codes), codebook=jnp.asarray(book))
    raise SerializationError(f"unknown source kind {meta['kind']}")


# -- hnsw serialization ------------------------------------------------------


def serialize_hnsw(
    hnsw: Hnsw,
    path: Union[str, Path],
    store_source: bool = True,
    extra_meta: Optional[dict] = None,
) -> None:
    """reference: serialize_hnsw (serialize.rs:33-124)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    layer_count = hnsw.layer_count

    # invalidate any previous meta up front: a crash mid-overwrite must not
    # leave stale meta that blesses a mix of old/new/truncated layer files
    meta_path = path / "meta"
    if meta_path.exists():
        meta_path.unlink()

    if store_source:
        serialize_source(hnsw.source, path / "comparator")

    for i, layer in enumerate(hnsw.layers):
        layer_number = layer_count - i - 1  # numbered from the bottom like the reference
        (path / f"layer.meta.{layer_number}").write_text(
            json.dumps(
                {
                    "node_count": layer.node_count,
                    "neighborhood_size": layer.neighborhood_size,
                }
            )
        )
        _write_array(path / f"layer.nodes.{layer_number}", np.asarray(layer.nodes), "int32")
        _write_array(
            path / f"layer.neighbors.{layer_number}", np.asarray(layer.neighbors), "int32"
        )

    # meta is written LAST so an interrupted serialization (crash mid-layer)
    # never leaves a directory that passes the "meta exists" completeness
    # check checkpoint consumers rely on
    meta = {
        "format_version": FORMAT_VERSION,
        "layer_count": layer_count,
        "metric": hnsw.metric.value,
        "build_parameters": params_to_dict(hnsw.build_parameters),
    }
    if extra_meta:
        meta.update(extra_meta)
    (path / "meta").write_text(json.dumps(meta))


def read_index_meta(path: Union[str, Path]) -> dict:
    """Read the index meta JSON (raises if absent/incomplete)."""
    return json.loads((Path(path) / "meta").read_text())


def deserialize_hnsw(
    path: Union[str, Path], source: Optional[Source] = None
) -> Hnsw:
    """reference: deserialize_hnsw (serialize.rs:126-209).  If ``source`` is
    None the comparator directory must exist."""
    path = Path(path)
    meta = json.loads((path / "meta").read_text())
    layer_count = meta["layer_count"]
    bp = build_params_from_dict(meta["build_parameters"])
    metric = Metric(meta["metric"])

    if source is None:
        if not (path / "comparator").exists():
            raise IndexNotFound(str(path))
        source = deserialize_source(path / "comparator")

    layers = []
    for i in range(layer_count):
        layer_number = layer_count - i - 1
        lm = json.loads((path / f"layer.meta.{layer_number}").read_text())
        nodes = _read_array(
            path / f"layer.nodes.{layer_number}", "int32", (lm["node_count"],)
        )
        neighbors = _read_array(
            path / f"layer.neighbors.{layer_number}",
            "int32",
            (lm["node_count"], lm["neighborhood_size"]),
        )
        layers.append(Layer(nodes=jnp.asarray(nodes), neighbors=jnp.asarray(neighbors)))
    return Hnsw(layers, source, metric, bp)


# -- quantized hnsw (reference: src/pq.rs:413-477) ---------------------------


def _serialize_quantizer(quantizer, path: Path) -> None:
    """Persist either quantizer kind under ``quantizer/``.

    HnswQuantizer (the reference's shared-codebook design, src/pq.rs:29-82)
    serializes its centroid graph like the reference does
    (src/pq.rs:433-441); a SubspaceQuantizer has no graph — its
    ``[nsub, K, dsub]`` codebooks dump raw with a ``quantizer_kind`` tag."""
    from parallel_hnsw.pq import SubspaceQuantizer

    path = Path(path)
    if isinstance(quantizer, SubspaceQuantizer):
        path.mkdir(parents=True, exist_ok=True)
        books = np.asarray(quantizer.codebooks, np.float32)
        _write_array(path / "codebooks", books, "float32")
        (path / "pq_build_parameters.json").write_text(
            json.dumps(
                {
                    "quantizer_kind": "subspace",
                    "codebooks_shape": list(books.shape),
                    "metric": quantizer.metric.value,
                    "pq_params": params_to_dict(quantizer.pq_params),
                }
            )
        )
        return
    serialize_hnsw(quantizer.hnsw, path)
    (path / "pq_build_parameters.json").write_text(
        json.dumps({"nsub": quantizer.nsub, "pq_params": params_to_dict(quantizer.pq_params)})
    )


def _deserialize_quantizer(path: Path):
    from parallel_hnsw.params import pq_build_params_from_dict
    from parallel_hnsw.pq import HnswQuantizer, SubspaceQuantizer

    path = Path(path)
    qmeta = json.loads((path / "pq_build_parameters.json").read_text())
    pqp = pq_build_params_from_dict(qmeta["pq_params"])
    if qmeta.get("quantizer_kind") == "subspace":
        books = _read_array(
            path / "codebooks", "float32", tuple(qmeta["codebooks_shape"])
        )
        return SubspaceQuantizer(jnp.asarray(books), Metric(qmeta["metric"]), pqp)
    return HnswQuantizer(deserialize_hnsw(path), qmeta["nsub"], pqp)


def serialize_quantized_hnsw(q, path: Union[str, Path]) -> None:
    """Nested layout: quantizer/, hnsw/, comparator/ (reference:
    src/pq.rs:433-452) plus pq meta."""
    from parallel_hnsw.pq import QuantizedHnsw

    assert isinstance(q, QuantizedHnsw)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    _serialize_quantizer(q.quantizer, path / "quantizer")
    serialize_hnsw(q.hnsw, path / "hnsw")
    serialize_source(q.full_source, path / "comparator")


def deserialize_quantized_hnsw(path: Union[str, Path]):
    from parallel_hnsw.pq import QuantizedHnsw

    path = Path(path)
    quantizer = _deserialize_quantizer(path / "quantizer")
    hnsw = deserialize_hnsw(path / "hnsw")
    full_source = deserialize_source(path / "comparator")
    return QuantizedHnsw(quantizer, hnsw, full_source)


# -- sharded hnsw -------------------------------------------------------------
# The reference has no distributed story; the layout extends its directory
# format (serialize.rs:33-209) with per-shard subdirectories so each host of a
# multi-host mesh can load only its own shards.


def serialize_sharded_hnsw(sh, path: Union[str, Path]) -> None:
    """Per-shard subdirs ``shard.{s}/`` (each the standard Hnsw layout plus
    ``global_ids``) under a top-level ``meta`` with mesh info."""
    from parallel_hnsw.parallel.sharded import ShardedHnsw

    assert isinstance(sh, ShardedHnsw)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "sharded_hnsw",
        "n_shards": sh.n_shards,
        "axis": sh.axis,
        "metric": sh.metric.value,
        "build_parameters": params_to_dict(sh.build_parameters),
    }
    (path / "meta").write_text(json.dumps(meta))
    for s in range(sh.n_shards):
        sdir = path / f"shard.{s}"
        shard = sh._shard_hnsw(s)
        serialize_hnsw(shard, sdir, store_source=True)
        gids = np.asarray(sh.global_ids[s], np.int32)
        _write_array(sdir / "global_ids", gids, "int32")
        (sdir / "shard.meta").write_text(json.dumps({"rows": int(gids.shape[0])}))


def deserialize_sharded_hnsw(path: Union[str, Path], mesh):
    """Rebuild a ShardedHnsw on ``mesh`` (the mesh itself is runtime state and
    is supplied by the caller; shard count must match)."""
    from parallel_hnsw.parallel.sharded import ShardedHnsw

    path = Path(path)
    meta = json.loads((path / "meta").read_text())
    if meta.get("kind") != "sharded_hnsw":
        raise SerializationError(f"not a sharded index: {path}")
    n_shards = meta["n_shards"]
    if mesh.devices.size != n_shards:
        raise SerializationError(
            f"mesh has {mesh.devices.size} devices but index has {n_shards} shards"
        )
    bp = build_params_from_dict(meta["build_parameters"])
    metric = Metric(meta["metric"])

    shard_hnsws = []
    gids_rows = []
    for s in range(n_shards):
        sdir = path / f"shard.{s}"
        shard_hnsws.append(deserialize_hnsw(sdir))
        rows = json.loads((sdir / "shard.meta").read_text())["rows"]
        gids_rows.append(_read_array(sdir / "global_ids", "int32", (rows,)))
    global_ids = jnp.asarray(np.stack(gids_rows))

    from parallel_hnsw.parallel.sharded import _stack_sources

    # equalize shard source row counts (they match by construction: the
    # round-robin split pads ragged shards before building)
    stacked_source = _stack_sources([h.source for h in shard_hnsws])
    out = ShardedHnsw(mesh, [], stacked_source, global_ids, metric, bp)
    out._restack_from_hnsws(shard_hnsws)
    return out


def serialize_sharded_quantized_hnsw(sq, path: Union[str, Path]) -> None:
    """Nested layout mirroring the single-chip PQ format (src/pq.rs:433-452):
    ``quantizer/`` + ``sharded/`` + per-shard ``full.{s}`` vector dumps."""
    from parallel_hnsw.parallel.sharded import ShardedQuantizedHnsw

    assert isinstance(sq, ShardedQuantizedHnsw)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    out_of_core = sq.full_stacked is None
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "sharded_quantized_hnsw",
        "nsub": sq.quantizer.nsub,
        "out_of_core": out_of_core,
    }
    if out_of_core:
        # full vectors live in the user's store (reference: the comparator
        # serializes via the USER's Serializable impl, src/lib.rs:76-83;
        # a missing store on load is IndexNotFound, src/serialize.rs:143-146).
        # Record the memmap filename as a reload hint when it has one.
        mm = sq.full_host.vectors
        meta["full_dim"] = int(sq.full_host.dim)
        if getattr(mm, "filename", None):
            meta["full_path"] = str(mm.filename)
    else:
        full = np.asarray(sq.full_stacked, np.float32)
        meta["full_shape"] = list(full.shape)
    (path / "meta").write_text(json.dumps(meta))
    _serialize_quantizer(sq.quantizer, path / "quantizer")
    serialize_sharded_hnsw(sq.sharded, path / "sharded")
    if not out_of_core:
        _write_array(path / "full", full, "float32")


def deserialize_sharded_quantized_hnsw(path: Union[str, Path], mesh, full_source=None):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from parallel_hnsw.parallel.sharded import ShardedQuantizedHnsw

    path = Path(path)
    meta = json.loads((path / "meta").read_text())
    if meta.get("kind") != "sharded_quantized_hnsw":
        raise SerializationError(f"not a sharded PQ index: {path}")
    quantizer = _deserialize_quantizer(path / "quantizer")
    sharded = deserialize_sharded_hnsw(path / "sharded", mesh)
    if meta.get("out_of_core"):
        from parallel_hnsw.graph import open_memmap_source

        if full_source is None:
            hint = meta.get("full_path")
            if not hint or not Path(hint).exists():
                raise SerializationError(
                    "out-of-core index: pass full_source= (the vector store "
                    "is external, like the reference's comparator — "
                    "src/serialize.rs:143-146)"
                )
            full_source = open_memmap_source(hint, meta["full_dim"])
        return ShardedQuantizedHnsw(quantizer, sharded, full_host=full_source)
    full = _read_array(path / "full", "float32", tuple(meta["full_shape"]))
    full_stacked = jax.device_put(
        jnp.asarray(full), NamedSharding(mesh, P(sharded.axis, None, None))
    )
    return ShardedQuantizedHnsw(quantizer, sharded, full_stacked)
