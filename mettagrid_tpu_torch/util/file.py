"""URI-addressed file IO: local, http(s), s3 (reference:
mettagrid_tpu/util/file.py).

boto3 is an optional dependency; s3:// operations raise a clear error
without it. Presigned S3 URLs read over plain HTTP."""

from __future__ import annotations

import os
import tempfile
import urllib.parse
import urllib.request
from contextlib import contextmanager
from typing import Union

try:
    import boto3  # type: ignore

    _HAS_BOTO3 = True
except ImportError:  # pragma: no cover
    _HAS_BOTO3 = False


def _require_boto3():
    if not _HAS_BOTO3:
        raise RuntimeError("s3:// paths require boto3, which is not installed")


def is_presigned_s3_url(url: str) -> bool:
    if not url.startswith(("http://", "https://")):
        return False
    q = urllib.parse.urlparse(url).query
    params = urllib.parse.parse_qs(q)
    return "X-Amz-Signature" in params or "Signature" in params


def _split_s3(path: str) -> tuple[str, str]:
    rest = path[len("s3://") :]
    bucket, _, key = rest.partition("/")
    return bucket, key


def write_data(path: str, data: Union[str, bytes], *, content_type: str = "application/octet-stream") -> None:
    if isinstance(data, str):
        data = data.encode()
    if path.startswith("s3://"):
        _require_boto3()
        bucket, key = _split_s3(path)
        boto3.client("s3").put_object(Bucket=bucket, Key=key, Body=data, ContentType=content_type)
        return
    if path.startswith(("http://", "https://")):
        req = urllib.request.Request(path, data=data, method="PUT", headers={"Content-Type": content_type})
        urllib.request.urlopen(req)
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def read(path: str) -> bytes:
    if path.startswith("s3://"):
        _require_boto3()
        bucket, key = _split_s3(path)
        return boto3.client("s3").get_object(Bucket=bucket, Key=key)["Body"].read()
    if path.startswith(("http://", "https://")):
        with urllib.request.urlopen(path) as r:
            return r.read()
    with open(path, "rb") as f:
        return f.read()


def exists(path: str) -> bool:
    if path.startswith("s3://"):
        _require_boto3()
        bucket, key = _split_s3(path)
        try:
            boto3.client("s3").head_object(Bucket=bucket, Key=key)
            return True
        except Exception:  # noqa: BLE001
            return False
    if path.startswith(("http://", "https://")):
        req = urllib.request.Request(path, method="HEAD")
        try:
            urllib.request.urlopen(req)
            return True
        except Exception:  # noqa: BLE001
            return False
    return os.path.exists(path)


def write_file(path: str, local_file: str, *, content_type: str = "application/octet-stream") -> None:
    with open(local_file, "rb") as f:
        write_data(path, f.read(), content_type=content_type)


def copy_data(src: str, dest: str, content_type: str = "application/octet-stream") -> None:
    write_data(dest, read(src), content_type=content_type)


@contextmanager
def local_copy(path: str):
    """Yield a local filesystem path for any URI (reference: file.py:148-173)."""
    if not path.startswith(("s3://", "http://", "https://")):
        yield path
        return
    suffix = os.path.splitext(urllib.parse.urlparse(path).path)[1]
    fd, tmp = tempfile.mkstemp(suffix=suffix)
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            f.write(read(path))
        yield tmp
    finally:
        os.unlink(tmp)


def http_url(path: str) -> str:
    """Map an s3:// path to its public https URL (reference: file.py:175-181)."""
    if path.startswith("s3://"):
        bucket, key = _split_s3(path)
        return f"https://{bucket}.s3.amazonaws.com/{key}"
    return path
