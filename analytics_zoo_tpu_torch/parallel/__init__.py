"""Port of ``analytics_zoo_tpu.parallel``: the mesh axes dp (data), sp
(sequence: ring, zigzag and Ulysses attention), ep (experts), pp
(pipeline) and the dp update sharding (ZeRO-1), over ``torch.distributed``
rank processes (``parallel/comm.py``). ``fsdp`` and ``tp`` placement is
not ported: its rules (``TP_RULES``, ``make_param_sharding``) are pure
spec functions here, and the Estimator raises for a mesh with either
above 1.

The JAX package's names, with one difference: ``collective_counts()``
takes no argument and returns the collectives this process has issued by
kind (``comm.collective_counts``; reset with
``comm.reset_collective_counts``), where JAX's counts the ops in a
program's HLO text.
"""

from ..common.context import build_mesh
from ..ops.attention import (full_attention, ring_attention_local,
                             sharded_attention, ulysses_attention_local)
from .comm import collective_counts
from .embedding_sharding import (TableSharding, owned_row_range, pad_rows,
                                 row_shard_spec, shard_embedding_tables,
                                 sharded_gather, sharded_table_layers)
from .pipeline import pipeline_apply, stack_stage_params
from .sharding import TP_RULES, make_param_sharding, replicated
from .update_sharding import (flat_exchange, flat_meta, make_comm_probe,
                              make_update_sharding, shard_spec_over_axis,
                              with_master_weights)

__all__ = [
    "pipeline_apply", "stack_stage_params",
    "TP_RULES", "TableSharding", "build_mesh", "collective_counts",
    "flat_exchange", "flat_meta", "full_attention", "make_comm_probe",
    "make_param_sharding", "make_update_sharding", "owned_row_range",
    "pad_rows", "replicated", "ring_attention_local", "row_shard_spec",
    "shard_embedding_tables", "shard_spec_over_axis", "sharded_attention",
    "sharded_gather", "sharded_table_layers", "ulysses_attention_local",
    "with_master_weights",
]
