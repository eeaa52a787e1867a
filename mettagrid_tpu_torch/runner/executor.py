"""Subprocess episode executor (reference: mettagrid_tpu/runner/executor.py).

    python -m mettagrid_tpu_torch.runner.executor <request.json> <result.json> --device=<device>

Reads an EpisodeRequest JSON, writes the EpisodeResult JSON; structured
errors go to <result.json>.error. SIGTERM produces a clean error file
instead of a stack dump. The episode runs on the caller's device, given as
an argument (``cuda``, ``cpu``).

Invoked by run_episode_isolated (episode_runner.py) — one process per
episode so a crashing policy cannot take down the caller.
"""

from __future__ import annotations

import argparse
import signal
import sys
import traceback

from mettagrid_tpu_torch.runner.types import EpisodeRequest, RunnerError


def _write_error(path: str, kind: str, message: str, tb: str = "") -> None:
    err = RunnerError(kind=kind, message=message, traceback=tb)
    with open(path + ".error", "w") as f:
        f.write(err.model_dump_json())


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(prog="executor")
    parser.add_argument("request_path")
    parser.add_argument("result_path")
    parser.add_argument("--device", required=True)
    args = parser.parse_args(argv[1:])
    result_path = args.result_path

    def on_sigterm(signum, frame):
        _write_error(result_path, "sigterm", "episode executor terminated")
        sys.exit(143)

    signal.signal(signal.SIGTERM, on_sigterm)

    try:
        with open(args.request_path) as f:
            request = EpisodeRequest.model_validate_json(f.read())
    except Exception as e:  # noqa: BLE001 - the error file is the report
        _write_error(result_path, "bad_request", str(e), traceback.format_exc())
        return 1

    try:
        from mettagrid_tpu_torch.runner.rollout import run_episode_local

        result = run_episode_local(request, device=args.device)
    except Exception as e:  # noqa: BLE001 - the error file is the report
        _write_error(result_path, "episode_failure", str(e), traceback.format_exc())
        return 1

    with open(result_path, "w") as f:
        f.write(result.model_dump_json())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
