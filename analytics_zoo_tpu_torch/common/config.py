"""Typed configuration (port of ``common/config.py``): the runtime config
(``MeshConfig``, ``PrecisionConfig``, ``RuntimeConfig``) that
``common/context.py`` reads, ``TrainConfig``, and ``ZOO_TPU_*``
environment overrides (:func:`apply_env_overrides`, the same variable
names as the JAX package: ``ZOO_TPU_MESH_TP=2``,
``ZOO_TPU_PRECISION_COMPUTE_DTYPE=bfloat16``, ...).

The field names and defaults are the JAX package's, so a config written for
one package reads the same in the other. ``RuntimeConfig.platform`` takes
``None`` (CUDA; with no CUDA the context raises), ``"cpu"``, or
``"gpu"``/``"cuda"``. Part of the machinery behind ``TrainConfig`` is not
ported yet: :func:`check_ported` raises ``NotImplementedError`` naming the
ROADMAP queue for every such field set away from its default, so no
setting is ever silently ignored. The Estimator calls it at construction
and at the start of every ``fit``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

_ENV_PREFIX = "ZOO_TPU_"


def _coerce(value: str, typ: Any) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ is str:
        return value
    # tuples, lists, optionals: through JSON
    try:
        return json.loads(value)
    except (json.JSONDecodeError, ValueError):
        return value


@dataclass
class MeshConfig:
    """Logical device-mesh layout over the axes ``dp`` (data), ``fsdp``
    (parameter and optimizer sharding within a replica), ``tp`` (tensor),
    ``sp`` (sequence), ``pp`` (pipeline) and ``ep`` (expert). An axis of
    ``0``/``None`` fills with the remaining devices."""

    dp: int = 0
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("dp", "fsdp", "tp", "sp", "pp", "ep")

    def sizes(self, n_devices: int) -> Tuple[int, ...]:
        fixed = [self.fsdp, self.tp, self.sp, self.pp, self.ep]
        known = 1
        for s in fixed:
            known *= max(1, s)
        dp = self.dp
        if dp in (0, None):
            if n_devices % known != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {known}")
            dp = n_devices // known
        total = dp * known
        if total != n_devices:
            raise ValueError(
                f"mesh {dp}x{fixed} = {total} does not match {n_devices} devices")
        return (dp,) + tuple(max(1, s) for s in fixed)


@dataclass
class PrecisionConfig:
    """Mixed-precision policy: parameters in ``param_dtype``, compute in
    ``compute_dtype``. f32 by default, so CPU comparisons are exact."""

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    output_dtype: str = "float32"


@dataclass
class RuntimeConfig:
    """The runtime context's knobs (``init_zoo_context``)."""

    mesh: MeshConfig = field(default_factory=MeshConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    platform: Optional[str] = None          # None = CUDA; "cpu", "gpu"/"cuda"
    num_virtual_devices: int = 0            # >0: that many CPU devices
    coordinator_address: Optional[str] = None  # set: join a process group
    num_processes: int = 1
    process_id: int = 0
    log_dir: Optional[str] = None
    seed: int = 0


@dataclass
class TrainConfig:
    """Training-engine knobs; see the JAX package's ``TrainConfig`` for
    each field's meaning."""

    batch_size: int = 256                   # GLOBAL batch
    max_epochs: int = 1
    gradient_clip_norm: Optional[float] = None
    gradient_clip_value: Optional[Tuple[float, float]] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every_n_iters: Optional[int] = None
    retry_times: int = 5
    retry_backoff_s: float = 0.0
    retry_max_backoff_s: float = 30.0
    retry_deadline_s: Optional[float] = None
    graceful_shutdown: bool = True
    log_every_n_steps: int = 50
    donate_state: bool = True               # False: keep the pre-step state
    shuffle: bool = True
    cache_on_device: bool = False
    scan_block_steps: int = 100
    prefetch_depth: int = 2
    grad_accum_steps: int = 1
    compute_dtype: Optional[str] = None
    update_sharding: Any = False
    graph_checks: Optional[str] = None
    hbm_budget_mb: Optional[float] = None
    async_checkpoint: bool = True


#: fields whose machinery the port does not have yet: the values it
#: accepts (the default first) and where the work is queued
_UNPORTED = {
    "graph_checks": ((None, "off"), "ROADMAP Queue 1, item 11 (the "
                     "analysis rules)"),
    "hbm_budget_mb": ((None,), "ROADMAP Queue 1, item 11 (the analysis "
                      "rules)"),
}


def check_ported(cfg: TrainConfig) -> TrainConfig:
    """Raise ``NotImplementedError`` for the first field set to a value
    whose machinery is not ported; return ``cfg`` otherwise."""
    for f in dataclasses.fields(cfg):
        rule = _UNPORTED.get(f.name)
        if rule is None:
            continue
        accepted, where = rule
        val = getattr(cfg, f.name)
        if val not in accepted:
            raise NotImplementedError(
                f"TrainConfig.{f.name}={val!r} is not supported by the "
                f"PyTorch port yet ({where}); leave it at {accepted[0]!r}")
    if cfg.compute_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"TrainConfig.compute_dtype={cfg.compute_dtype!r}; "
                         f"known: None, 'float32', 'bfloat16'")
    return cfg


def apply_env_overrides(cfg: Any, prefix: str = _ENV_PREFIX) -> Any:
    """A copy of dataclass ``cfg`` with ``ZOO_TPU_<FIELD>`` environment
    overrides applied; nested dataclasses read ``ZOO_TPU_<OUTER>_<FIELD>``
    (``ZOO_TPU_MESH_TP=2``)."""
    if not dataclasses.is_dataclass(cfg):
        return cfg
    updates = {}
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        if dataclasses.is_dataclass(val):
            updates[f.name] = apply_env_overrides(
                val, prefix + f.name.upper() + "_")
        else:
            env_key = prefix + f.name.upper()
            if env_key in os.environ:
                updates[f.name] = _coerce(
                    os.environ[env_key],
                    f.type if isinstance(f.type, type) else type(val))
    return dataclasses.replace(cfg, **updates)


def config_to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: config_to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [config_to_dict(v) for v in cfg]
    return cfg


__all__ = ["MeshConfig", "PrecisionConfig", "RuntimeConfig", "TrainConfig",
           "apply_env_overrides", "check_ported", "config_to_dict"]
