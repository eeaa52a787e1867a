"""Policy discovery and loading (reference: mettagrid_tpu/policy/loader.py).

Shorthand names ("random", "lstm", "stateless", "puffer", …) resolve through
the auto-registration metaclass; `discover_and_register_policies` walks policy
packages so third-party policies can register themselves without hard deps.
"""

from __future__ import annotations

import functools
import importlib
import logging
import pkgutil
from typing import Optional

from mettagrid_tpu_torch.policy.policy import (
    POLICY_REGISTRY,
    AgentPolicy,
    MultiAgentPolicy,
    PolicySpec,
)
from mettagrid_tpu_torch.util.module import refuse_reference

logger = logging.getLogger(__name__)

# Packages scanned for self-registering policies.
POLICY_PACKAGES = ["mettagrid_tpu_torch.policy"]


def initialize_or_load_policy(
    policy_env_info,
    policy_spec: PolicySpec,
    device_override: str | None = None,
) -> MultiAgentPolicy:
    """Instantiate a policy from its class path/shorthand and load weights.

    Expects local paths in the spec (resolve remote URIs with
    prepare_policy_spec first)."""
    kwargs = dict(policy_spec.init_kwargs or {})
    if device_override is not None and "device" in kwargs:
        kwargs["device"] = device_override

    discover_and_register_policies()
    policy_class = policy_spec.resolve_class()
    policy = policy_class(policy_env_info, **kwargs)

    if policy_spec.policy_data_path:
        policy.load_policy_data(policy_spec.policy_data_path)

    if not isinstance(policy, MultiAgentPolicy):
        if isinstance(policy, AgentPolicy):
            raise TypeError(
                f"Policy {policy_spec.class_path} is an AgentPolicy; wrap it in a "
                f"MultiAgentPolicy (which returns AgentPolicy via agent_policy)"
            )
        raise TypeError(f"Policy {policy_spec.class_path} is not a MultiAgentPolicy")
    return policy


def resolve_policy_class_path(policy: str) -> str:
    """Resolve a shorthand like "random"/"lstm" to a full class path (or pass
    through an already-full path)."""
    discover_and_register_policies()
    cls = POLICY_REGISTRY.get(policy)
    if cls is not None:
        return f"{cls.__module__}.{cls.__qualname__}"
    return policy


def get_policy_class_shorthand(policy: str) -> Optional[str]:
    """Reverse lookup: full class path -> shorthand, if registered."""
    for short, cls in POLICY_REGISTRY.items():
        if f"{cls.__module__}.{cls.__qualname__}" == policy:
            return short
    return None


@functools.cache
def _walk_and_import_package(package_name: str) -> None:
    """Import all modules in a package so policies register themselves."""
    try:
        package = importlib.import_module(package_name)
    except ImportError:
        return
    package_path = getattr(package, "__path__", None)
    if package_path is None:
        return
    for path in package_path:
        for _finder, name, ispkg in pkgutil.iter_modules([path], package_name + "."):
            try:
                importlib.import_module(name)
                if ispkg:
                    _walk_and_import_package(name)
            except (ImportError, AttributeError, TypeError, OSError) as exc:
                logger.debug("Skipping %s during policy discovery: %s", name, exc)


def discover_and_register_policies(*packages: str) -> None:
    for package_name in packages:
        refuse_reference(package_name)
    for package_name in [*POLICY_PACKAGES, *packages]:
        _walk_and_import_package(package_name)
