"""URI scheme resolvers: parse policy/artifact URIs into typed descriptors
(reference: mettagrid_tpu/util/uri_resolvers.py).

Checkpoint naming convention: a path stem of ``<run_name>:v<epoch>``
yields CheckpointMetadata.
"""

from __future__ import annotations

from pathlib import Path
from typing import Literal, Optional, Union
from urllib.parse import unquote, urlparse

from pydantic import BaseModel


def _extract_run_and_epoch(path_str: str) -> Optional[tuple[str, int]]:
    stem = Path(path_str).stem
    if ":v" in stem:
        run_name, suffix = stem.rsplit(":v", 1)
        if run_name and suffix.isdigit():
            return (run_name, int(suffix))
    return None


class CheckpointMetadata(BaseModel, frozen=True):
    run_name: str
    epoch: int
    uri: str


class FileParsedScheme(BaseModel, frozen=True):
    scheme: Literal["file"] = "file"
    canonical: str
    local_path: Path

    @property
    def checkpoint_info(self) -> Optional[tuple[str, int]]:
        return _extract_run_and_epoch(str(self.local_path))


class S3ParsedScheme(BaseModel, frozen=True):
    scheme: Literal["s3"] = "s3"
    canonical: str
    bucket: str
    key: str

    @property
    def local_path(self) -> None:
        return None

    @property
    def checkpoint_info(self) -> Optional[tuple[str, int]]:
        return _extract_run_and_epoch(self.key)


class HttpParsedScheme(BaseModel, frozen=True):
    scheme: Literal["http"] = "http"
    canonical: str
    url: str

    @property
    def local_path(self) -> None:
        return None

    @property
    def checkpoint_info(self) -> Optional[tuple[str, int]]:
        return _extract_run_and_epoch(urlparse(self.url).path)


ParsedScheme = Union[FileParsedScheme, S3ParsedScheme, HttpParsedScheme]


def parse_uri(uri: str) -> ParsedScheme:
    """Parse a URI (or bare path) into its typed scheme descriptor."""
    if uri.startswith("s3://"):
        rest = uri[len("s3://") :]
        bucket, _, key = rest.partition("/")
        if not bucket or not key:
            raise ValueError(f"Malformed s3 URI: {uri}")
        return S3ParsedScheme(canonical=uri, bucket=bucket, key=key)
    if uri.startswith(("http://", "https://")):
        return HttpParsedScheme(canonical=uri, url=uri)
    if uri.startswith("file://"):
        parsed = urlparse(uri)
        combined = unquote(parsed.path)
        if parsed.netloc:
            combined = f"{parsed.netloc}{combined}"
        if not combined:
            raise ValueError(f"Malformed file URI: {uri}")
        local_path = Path(combined).expanduser().resolve()
    else:
        local_path = Path(uri).expanduser().resolve()
    return FileParsedScheme(canonical=local_path.as_uri(), local_path=local_path)


def checkpoint_metadata(uri: str) -> Optional[CheckpointMetadata]:
    """CheckpointMetadata for URIs following the '<run>:v<epoch>' convention."""
    parsed = parse_uri(uri)
    info = parsed.checkpoint_info
    if info is None:
        return None
    return CheckpointMetadata(run_name=info[0], epoch=info[1], uri=parsed.canonical)


def resolve_latest_checkpoint(dir_uri: str) -> Optional[str]:
    """For a local directory, the member checkpoint URI with the highest
    epoch (reference: FileSchemeResolver._get_latest_checkpoint_uri)."""
    parsed = parse_uri(dir_uri)
    if not isinstance(parsed, FileParsedScheme) or not parsed.local_path.is_dir():
        return None
    best: Optional[tuple[int, str]] = None
    for entry in parsed.local_path.iterdir():
        info = _extract_run_and_epoch(entry.name)
        if info is None:
            continue
        if best is None or info[1] > best[0]:
            best = (info[1], entry.as_uri())
    return best[1] if best else None
