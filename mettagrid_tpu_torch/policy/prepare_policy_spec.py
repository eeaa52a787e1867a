"""Prepare PolicySpecs from submission archives and remote sources
(reference: mettagrid_tpu/policy/prepare_policy_spec.py).

Handles: zip-safe extraction with cross-process file locking, spec/manifest
resolution, one-shot setup scripts, sys.path injection for bundled policy
code, and URI localization (file/http/s3 via util.file)."""

from __future__ import annotations

import atexit
import contextlib
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import zipfile
from pathlib import Path
from typing import Iterator, Optional

from mettagrid_tpu_torch.policy.policy import PolicySpec
from mettagrid_tpu_torch.policy.submission import (
    LEGACY_MANIFEST_FILENAMES,
    POLICY_MANIFEST_FILENAME,
    POLICY_SPEC_FILENAME,
    SubmissionPolicySpec,
    load_policy_manifest,
)

DEFAULT_POLICY_CACHE_DIR = Path(tempfile.gettempdir()) / "mettagrid-tpu-torch-policy-cache"

_registered_cleanup_dirs: set[Path] = set()
_executed_setup_scripts: set[Path] = set()


@contextlib.contextmanager
def _exclusive_file_lock(lock_path: Path) -> Iterator[None]:
    """Cross-process exclusive lock via fcntl on a sentinel file."""
    import fcntl

    lock_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lock_path, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def validate_submission_archive_member(entry: zipfile.ZipInfo, destination_root: Path) -> None:
    """Reject zip entries that escape the destination or are symlinks."""
    # Symlink mode bits live in the high bytes of external_attr.
    if (entry.external_attr >> 16) & 0o170000 == 0o120000:
        raise ValueError(f"Submission archives may not contain symlinks: {entry.filename}")
    target = (destination_root / entry.filename).resolve()
    if not str(target).startswith(str(destination_root.resolve()) + os.sep) and target != destination_root.resolve():
        raise ValueError(f"Zip entry escapes extraction root: {entry.filename}")


def extract_submission_archive(archive_path: Path, destination: Path) -> None:
    destination.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(archive_path) as zf:
        for entry in zf.infolist():
            validate_submission_archive_member(entry, destination)
        zf.extractall(destination)


def _resolve_spec_data_path(data_path: Optional[str], extraction_root: Path) -> Optional[str]:
    if data_path is None:
        return None
    candidate = Path(data_path)
    if candidate.is_absolute():
        return str(candidate)
    return str(extraction_root / candidate)


def _run_setup_script(setup_script: str, extraction_root: Path) -> None:
    """Run the archive's setup script once (marker files guard re-runs)."""
    script_path = extraction_root / setup_script
    if not script_path.exists():
        raise FileNotFoundError(f"setup_script {setup_script!r} not found in {extraction_root}")
    done_marker = extraction_root / f".setup-{hashlib.sha256(setup_script.encode()).hexdigest()[:16]}.done"
    with _exclusive_file_lock(extraction_root / ".setup.lock"):
        if done_marker.exists():
            return
        subprocess.run(
            [sys.executable, str(script_path)], cwd=str(extraction_root), check=True
        )
        done_marker.touch()


def _cleanup_cache_dir(cache_dir: Path) -> None:
    shutil.rmtree(cache_dir, ignore_errors=True)


def localize_policy_uri(uri: str, cache_dir: Optional[Path] = None) -> Path:
    """Fetch a policy archive URI (file/http/s3) to a local path, cached by
    content address of the URI."""
    from mettagrid_tpu_torch.util.file import read as uri_read

    if "://" not in uri or uri.startswith("file://"):
        return Path(uri.removeprefix("file://"))
    cache_dir = cache_dir or DEFAULT_POLICY_CACHE_DIR
    cache_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(uri.rstrip("/").encode()).hexdigest()
    suffix = ".zip" if uri.rstrip("/").endswith(".zip") else ""
    local_path = cache_dir / f"{digest}{suffix}"
    if not local_path.exists():
        tmp_path = cache_dir / f"tmp-{digest}"
        tmp_path.write_bytes(uri_read(uri))
        os.rename(tmp_path, local_path)
    return local_path


def load_policy_spec_from_path(
    local_path: Path,
    *,
    device: str | None = None,
    remove_downloaded_copy_on_exit: bool = False,
    force_dest: Optional[Path] = None,
) -> PolicySpec:
    """Resolve a submission archive or directory into a loadable PolicySpec.

    Extracts zips into the cache (lock-guarded, once), reads
    policy_spec.json or the TOML manifest, runs the setup script, resolves
    the data path, and puts the bundle on sys.path."""
    if local_path.is_dir():
        extraction_root = local_path
    else:
        extraction_root = force_dest or (
            DEFAULT_POLICY_CACHE_DIR / hashlib.sha256(local_path.resolve().as_uri().encode()).hexdigest()
        ).with_suffix(".d")
        extraction_root.mkdir(parents=True, exist_ok=True)
        with _exclusive_file_lock(extraction_root / ".extraction.lock"):
            if not (extraction_root / ".extraction_complete").exists():
                extract_submission_archive(local_path, extraction_root)
                (extraction_root / ".extraction_complete").touch()
                if remove_downloaded_copy_on_exit and extraction_root not in _registered_cleanup_dirs:
                    _registered_cleanup_dirs.add(extraction_root)
                    atexit.register(_cleanup_cache_dir, extraction_root)

    spec_path = extraction_root / POLICY_SPEC_FILENAME
    manifest_candidates = [extraction_root / POLICY_MANIFEST_FILENAME] + [
        extraction_root / name for name in LEGACY_MANIFEST_FILENAMES
    ]
    if spec_path.exists():
        submission_spec = SubmissionPolicySpec.model_validate_json(spec_path.read_text())
    else:
        manifest_path = next((p for p in manifest_candidates if p.exists()), None)
        if manifest_path is None:
            raise FileNotFoundError(
                f"Neither {POLICY_SPEC_FILENAME} nor a policy manifest found in: {extraction_root}"
            )
        submission_spec = load_policy_manifest(manifest_path)

    if submission_spec.setup_script and extraction_root not in _executed_setup_scripts:
        _run_setup_script(submission_spec.setup_script, extraction_root)
        _executed_setup_scripts.add(extraction_root)

    spec = PolicySpec(
        class_path=submission_spec.class_path,
        policy_data_path=_resolve_spec_data_path(submission_spec.data_path, extraction_root),
        init_kwargs=dict(submission_spec.init_kwargs),
    )
    if device is not None and "device" in spec.init_kwargs:
        spec.init_kwargs["device"] = device

    sys_path_entry = str(extraction_root.resolve())
    if sys_path_entry not in sys.path:
        sys.path.insert(0, sys_path_entry)
    return spec


def prepare_policy_spec(uri_or_path: str, *, device: str | None = None) -> PolicySpec:
    """One-call convenience: localize a URI and resolve the archive/dir into a
    PolicySpec. Plain class paths / shorthands pass through untouched."""
    path = Path(uri_or_path.removeprefix("file://")) if "://" not in uri_or_path or uri_or_path.startswith("file://") else None
    if path is not None and not path.exists():
        # Not a filesystem path: treat as a class path or registry shorthand.
        return PolicySpec(class_path=uri_or_path)
    local = path if path is not None else localize_policy_uri(uri_or_path)
    return load_policy_spec_from_path(local, device=device)
