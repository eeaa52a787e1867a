"""Policy submission archives: manifest and spec formats
(reference: mettagrid_tpu/policy/submission.py)."""

from __future__ import annotations

import tempfile
import tomllib
from pathlib import Path
from typing import Optional

from pydantic import BaseModel, Field

POLICY_SPEC_FILENAME = "policy_spec.json"
POLICY_MANIFEST_FILENAME = "mettagrid.toml"
# Accepted legacy manifest name for interop with reference-format archives.
LEGACY_MANIFEST_FILENAMES = ("cogames.toml",)


class SubmissionPolicySpec(BaseModel):
    """Serialized policy spec stored in submission zips; extends the core
    PolicySpec with archive-relative paths and an optional setup script."""

    class_path: str = Field(description="Fully qualified path to the policy class")
    data_path: Optional[str] = Field(default=None, description="Relative path to policy data")
    init_kwargs: dict = Field(default_factory=dict)
    setup_script: Optional[str] = Field(
        default=None, description="Relative path to a setup script run once before loading"
    )


def load_policy_manifest(path: Path) -> SubmissionPolicySpec:
    """Read a TOML manifest with a [policy] table into a SubmissionPolicySpec."""
    data = tomllib.loads(path.read_text())
    policy = data.get("policy")
    if not isinstance(policy, dict):
        raise ValueError(f"{path} is missing a [policy] table")
    return SubmissionPolicySpec(
        class_path=policy["class_path"],
        data_path=policy.get("data_path"),
        init_kwargs=dict(policy.get("init_kwargs") or {}),
        setup_script=policy.get("setup_script"),
    )


def write_submission_policy_spec(path: Path, spec: SubmissionPolicySpec) -> None:
    """Atomically write the spec JSON next to the target path."""
    with tempfile.NamedTemporaryFile(
        dir=path.parent, prefix=f".{path.name}.", suffix=".tmp", delete=False
    ) as tmp:
        tmp_path = Path(tmp.name)
        tmp.write(spec.model_dump_json().encode("utf-8"))
    tmp_path.replace(path)
