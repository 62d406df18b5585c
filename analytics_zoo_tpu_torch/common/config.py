"""Training configuration (port of ``TrainConfig`` in ``common/config.py``).

The field names and defaults are the JAX package's, so a config written for
one package reads the same in the other. Part of the machinery behind them
is not ported yet: :func:`check_ported` raises ``NotImplementedError``
naming the ROADMAP queue for every such field set away from its default,
so no setting is ever silently ignored. The Estimator calls it at
construction and at the start of every ``fit``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple


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
    donate_state: bool = True               # the port always updates in place
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
    "donate_state": ((True,), "ROADMAP Queue 1 (Estimator remainder): the "
                     "port updates in place"),
    "update_sharding": ((False, None), "ROADMAP Queue 1, item 9 "
                        "(multi-GPU)"),
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


__all__ = ["TrainConfig", "check_ported"]
