"""Operator snapshot archives (port of nomad_tpu/server/snapshot.py;
upstream: helper/snapshot/snapshot.go): a state/restore.py dump_state
blob as one gzip file, a JSON header line (format version, index,
creation time, the payload's SHA-256) then the JSON payload. The
archive's bytes are the reference's form, so either package restores
the other's archive.
"""
from __future__ import annotations

import gzip
import hashlib
import json
import time
from typing import Tuple

FORMAT_VERSION = 1


def save_archive(state_blob: dict, index: int) -> bytes:
    """A checksummed archive of a dump_state blob."""
    payload = json.dumps(state_blob, separators=(",", ":"),
                         sort_keys=True).encode()
    meta = {
        "format_version": FORMAT_VERSION,
        "index": index,
        "created_at": time.time(),
        "checksum": "sha-256=" + hashlib.sha256(payload).hexdigest(),
    }
    framed = json.dumps({"meta": meta}).encode() + b"\n" + payload
    return gzip.compress(framed)


def load_archive(data: bytes) -> Tuple[dict, dict]:
    """(meta, state blob) of an archive. Raises ValueError for bytes
    that are not gzip, a header that does not parse, another format
    version, or a payload whose checksum differs: before any byte
    reaches a store."""
    try:
        framed = gzip.decompress(data)
    except (OSError, EOFError) as e:
        raise ValueError(f"not a snapshot archive: {e}")
    try:
        header, payload = framed.split(b"\n", 1)
        meta = json.loads(header)["meta"]
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"malformed snapshot header: {e}")
    if not isinstance(meta, dict):
        raise ValueError("malformed snapshot header: meta is not an object")
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported snapshot version {meta.get('format_version')}")
    digest = "sha-256=" + hashlib.sha256(payload).hexdigest()
    if digest != meta.get("checksum"):
        raise ValueError("snapshot checksum mismatch (archive corrupted)")
    return meta, json.loads(payload)
