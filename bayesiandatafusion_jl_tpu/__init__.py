"""Bayesian data fusion on an accelerator: BPMF / Macau Gibbs sampling on JAX.

A from-scratch, accelerator-first re-design of the capabilities of
``jaak-s/BayesianDataFusion.jl`` (see SURVEY.md), run on NVIDIA GPUs
through XLA.  Export list mirrors the
reference module spine (src/BayesianDataFusion.jl [HIGH]): RelationData,
Relation, Entity, IndexedDF, macau, assign_to_test/add_relation/
set_precision (Julia's bang-functions), SparseBinMatrix and the sparse I/O
helpers.  Additions without a reference counterpart live under ops/,
parallel/ and utils/.
"""

from .models.data import (Entity, EntityModel, IndexedDF, Relation,
                          RelationData, RelationModel)
from .models.engine import (CompiledProblem, MacauEngine, macau,
                            predict_out_of_matrix,
                            predictions_frame)
from .ops.sparse import (SparseBinMatrix, read_matrix_market,
                         read_sparse_binary, read_sparse_float64,
                         write_matrix_market, write_sparse_binary,
                         write_sparse_float64)
from .utils.config import MacauConfig

__version__ = "0.1.0"

__all__ = [
    "Entity", "EntityModel", "IndexedDF", "Relation", "RelationData",
    "RelationModel", "macau", "MacauEngine", "MacauConfig",
    "CompiledProblem", "SparseBinMatrix", "predict_out_of_matrix",
    "predictions_frame",
    "read_sparse_binary", "write_sparse_binary",
    "read_sparse_float64", "write_sparse_float64",
    "read_matrix_market", "write_matrix_market",
]
