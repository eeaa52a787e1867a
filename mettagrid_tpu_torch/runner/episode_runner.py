"""Isolated episode runner: one subprocess per episode
(reference: mettagrid_tpu/runner/episode_runner.py — error-file protocol,
policy-log capture with a size cap, timeouts)."""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Optional

from mettagrid_tpu_torch.engine.state import resolve_device
from mettagrid_tpu_torch.runner.types import EpisodeRequest, EpisodeResult, RunnerError

LOG_CAP_BYTES = 100 * 1024 * 1024  # reference: 100MB policy-log cap


def run_episode_isolated(
    request: EpisodeRequest,
    timeout_s: Optional[float] = 600.0,
    device=None,
) -> EpisodeResult:
    """Run one episode in a fresh subprocess on ``device`` (None means CUDA,
    and raises without a card unless the caller passes device="cpu"), which
    the executor takes as an argument; failures come back as
    EpisodeResult.error instead of raising."""
    device = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="mg_episode_") as tmp:
        request_path = os.path.join(tmp, "request.json")
        result_path = os.path.join(tmp, "result.json")
        log_path = os.path.join(tmp, "episode.log")
        with open(request_path, "w") as f:
            f.write(request.model_dump_json())

        cmd = [sys.executable, "-m", "mettagrid_tpu_torch.runner.executor", request_path, result_path,
               f"--device={device}"]
        with open(log_path, "wb") as log_f:
            try:
                proc = subprocess.run(cmd, stdout=log_f, stderr=subprocess.STDOUT, timeout=timeout_s)
            except subprocess.TimeoutExpired:
                return EpisodeResult(error=f"episode timed out after {timeout_s}s")

        error_path = result_path + ".error"
        if os.path.exists(error_path):
            with open(error_path) as f:
                err = RunnerError.model_validate_json(f.read())
            return EpisodeResult(error=f"{err.kind}: {err.message}")
        if not os.path.exists(result_path):
            log_tail = _tail(log_path)
            return EpisodeResult(
                error=f"executor exited {proc.returncode} with no result\n{log_tail}"
            )
        with open(result_path) as f:
            return EpisodeResult.model_validate_json(f.read())


def _tail(path: str, limit: int = 4000) -> str:
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if size > min(limit, LOG_CAP_BYTES):
                f.seek(-limit, os.SEEK_END)
            return f.read().decode(errors="replace")
    except OSError:
        return ""
