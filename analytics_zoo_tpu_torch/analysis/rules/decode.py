"""The shared-prefix write-isolation check (port of
``lint_prefix_write_isolation`` in ``analytics_zoo_tpu/analysis/rules/decode.py``).

A suffix prefill from position ``start`` writes K/V into the pages backing
positions ``start ..``; each of those must be exclusively the stream's
(pool refcount 1), or the write would land in a page that sibling streams
and the prefix cache read. The batcher runs the check before every prefill
from a prefix hit and raises on a finding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation: the rule's id, its severity, where it was found, a
    message and the details it names."""

    rule: str
    severity: str
    where: str
    message: str
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)


def lint_prefix_write_isolation(pool, row, start: int, *,
                                page_size: int,
                                where: str = "serving.generation"
                                ) -> List[Finding]:
    """``pool``: the :class:`~analytics_zoo_tpu_torch.ops.kv_cache.PagePool`;
    ``row``: the stream's page ids in table order; ``start``: the first
    position the suffix dispatch writes. Pages strictly below
    ``start // page_size`` are the read-only shared prefix and are not
    flagged. Returns one error finding per written page with more than one
    reference (empty = isolated)."""
    out: List[Finding] = []
    first_written = int(start) // int(page_size)
    for idx in range(first_written, len(row)):
        page = int(row[idx])
        refs = pool.ref_count(page)
        if refs > 1:
            out.append(Finding(
                "prefix-share-isolation", "error", f"pool:{where}",
                f"page {page} (table index {idx}) is written by the suffix "
                f"prefill from position {start} but carries {refs} "
                f"references — shared pages must be copy-on-write before "
                f"any paged_write touches them",
                {"page": page, "table_index": idx, "refcount": refs,
                 "start": int(start)}))
    return out


__all__ = ["Finding", "lint_prefix_write_isolation"]
