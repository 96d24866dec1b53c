"""Entity/Relation data model — the reference's L1/L2 layers.

Reference counterparts (SURVEY.md §2/§3):
  - ``IndexedDF``   (src/IndexedDF.jl [MED]): N-way sparse relation with
    per-mode inverted indexes.  Here the inverted index is *not* kept as a
    runtime structure — it becomes the compile-time bucketed layout
    (ops/layout.py); IndexedDF keeps only the COO arrays + utilities.
  - ``Entity``, ``Relation``, ``RelationData``, ``EntityModel``,
    ``RelationModel`` (src/RelationData.jl [HIGH]): the typed fusion graph
    with priors, side info, per-relation noise precision and test split.
  - ``assignToTest!`` / ``addRelation!`` / ``setPrecision!`` →
    ``assign_to_test`` / ``add_relation`` / ``set_precision``.

This layer is host-side NumPy; the engine (models/engine.py) compiles it to
static device arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..ops.sparse import SparseBinMatrix


class IndexedDF:
    """N-way sparse relation: integer index columns + a value column.

    Replaces the reference's DataFrame-backed IndexedDF; the per-mode
    inverted index is built lazily (``index(mode)``) and the device engine
    instead compiles a bucketed layout from the raw COO arrays.
    """

    def __init__(self, idx: np.ndarray, vals: np.ndarray,
                 shape: Sequence[int]):
        idx = np.asarray(idx)
        if idx.ndim != 2:
            raise ValueError("idx must be [nnz, D]")
        self.idx = np.ascontiguousarray(idx, np.int32)
        self.vals = np.asarray(vals, np.float64).ravel()
        if self.vals.shape[0] != self.idx.shape[0]:
            raise ValueError("idx and vals length mismatch")
        self.shape = tuple(int(s) for s in shape)
        if len(self.shape) != self.idx.shape[1]:
            raise ValueError("shape arity mismatch")
        for d, s in enumerate(self.shape):
            if self.idx.shape[0] and (self.idx[:, d].min() < 0
                                      or self.idx[:, d].max() >= s):
                raise ValueError(f"index out of range in mode {d}")

    @property
    def nnz(self) -> int:
        return int(self.idx.shape[0])

    @property
    def arity(self) -> int:
        return len(self.shape)

    def size(self, mode: Optional[int] = None):
        return self.shape if mode is None else self.shape[mode]

    def degrees(self, mode: int) -> np.ndarray:
        return np.bincount(self.idx[:, mode], minlength=self.shape[mode])

    def index(self, mode: int) -> List[np.ndarray]:
        """Inverted index: per-instance observation row ids (O(deg) gather)."""
        order = np.argsort(self.idx[:, mode], kind="stable")
        deg = self.degrees(mode)
        ptr = np.concatenate([[0], np.cumsum(deg)])
        return [order[ptr[i]:ptr[i + 1]] for i in range(self.shape[mode])]

    def remove_samples(self, rows: np.ndarray) -> "IndexedDF":
        """Drop observation rows (test-split carve-out, SURVEY §4.8)."""
        keep = np.ones(self.nnz, bool)
        keep[np.asarray(rows, np.int64)] = False
        return IndexedDF(self.idx[keep], self.vals[keep], self.shape)

    @classmethod
    def from_dense(cls, m: np.ndarray) -> "IndexedDF":
        m = np.asarray(m)
        nz = np.nonzero(m)
        return cls(np.stack(nz, axis=1), m[nz], m.shape)

    @classmethod
    def from_scipy(cls, m) -> "IndexedDF":
        coo = m.tocoo()
        return cls(np.stack([coo.row, coo.col], axis=1), coo.data, coo.shape)


FeatureMatrix = Union[SparseBinMatrix, np.ndarray, None]


@dataclasses.dataclass
class EntityModel:
    """Mutable per-entity sampler state (reference EntityModel [MED]).

    ``lambda_beta=None`` means "use MacauConfig.lambda_beta" — the engines
    resolve it through :func:`resolved_lambda_beta` so the kwarg-mirroring
    ``macau(..., lambda_beta=...)`` API actually takes effect unless the
    user set a per-entity value explicitly.
    """

    U: Optional[np.ndarray] = None          # [N, K] latent sample
    mu: Optional[np.ndarray] = None         # [K]
    Lambda: Optional[np.ndarray] = None     # [K, K]
    beta: Optional[np.ndarray] = None       # [F, K] link matrix
    uhat: Optional[np.ndarray] = None       # [N, K] = X beta
    lambda_beta: Optional[float] = None


class Entity:
    """One entity type (e.g. compound, target) with optional side info F."""

    def __init__(self, name: str, count: Optional[int] = None,
                 F: FeatureMatrix = None):
        self.name = name
        self.count = count
        if F is not None and not isinstance(F, SparseBinMatrix):
            if hasattr(F, "tocoo"):
                F = SparseBinMatrix.from_scipy(F)
            else:
                F = SparseBinMatrix.from_dense(np.asarray(F))
        self.F: Optional[SparseBinMatrix] = F
        if F is not None:
            if count is not None and count != F.shape[0]:
                raise ValueError("feature rows != entity count")
            self.count = F.shape[0]
        self.model = EntityModel()
        # None = auto (use direct X'X path iff F small; SURVEY §4.4)
        self.use_ff: Optional[bool] = None

    @property
    def has_features(self) -> bool:
        return self.F is not None

    @property
    def num_features(self) -> int:
        return 0 if self.F is None else self.F.shape[1]

    def __repr__(self):
        f = f", F={self.F.shape}" if self.F is not None else ""
        return f"Entity({self.name!r}, count={self.count}{f})"


@dataclasses.dataclass
class RelationModel:
    """Mutable per-relation sampler state (reference RelationModel [MED]).

    ``alpha``/``alpha_sample`` default to None = "use the MacauConfig
    value"; ``set_precision`` (the reference's ``setPrecision!``) sets
    explicit per-relation overrides.  Resolution happens through
    :func:`resolved_alpha` / :func:`resolved_alpha_sample`.
    """

    alpha: Optional[float] = None
    alpha_sample: Optional[bool] = None
    mean_value: float = 0.0


def resolved_alpha(rel: "Relation", cfg) -> float:
    """Per-relation noise precision: model override else config value."""
    a = rel.model.alpha
    return float(cfg.alpha if a is None else a)


def resolved_alpha_sample(rel: "Relation", cfg) -> bool:
    """Whether alpha_r is Gamma-sampled: model override else config."""
    s = rel.model.alpha_sample
    return bool(cfg.alpha_sample if s is None else s)


def resolved_lambda_beta(ent: "Entity", cfg) -> float:
    """Initial link-matrix regularizer: model override else config."""
    lb = ent.model.lambda_beta
    return float(cfg.lambda_beta if lb is None else lb)


class Relation:
    """One observed sparse relation over D >= 2 entities."""

    def __init__(self, data: IndexedDF, name: str,
                 entities: Sequence[Entity],
                 class_cut: Optional[float] = None):
        if len(entities) != data.arity:
            raise ValueError("entities list must match relation arity")
        for d, e in enumerate(entities):
            if e.count is None:
                e.count = data.shape[d]
            elif e.count != data.shape[d]:
                raise ValueError(
                    f"entity {e.name} count {e.count} != relation dim "
                    f"{data.shape[d]} (mode {d})")
        self.name = name
        self.data = data
        self.entities = list(entities)
        self.class_cut = class_cut
        self.model = RelationModel()
        # test split (SURVEY §4.8)
        self.test_idx: np.ndarray = np.zeros((0, data.arity), np.int32)
        self.test_vals: np.ndarray = np.zeros((0,), np.float64)

    @property
    def arity(self) -> int:
        return self.data.arity

    def set_test(self, idx: np.ndarray, vals: np.ndarray) -> None:
        self.test_idx = np.ascontiguousarray(idx, np.int32)
        self.test_vals = np.asarray(vals, np.float64).ravel()

    def __repr__(self):
        return (f"Relation({self.name!r}, shape={self.data.shape}, "
                f"nnz={self.data.nnz}, test={len(self.test_vals)})")


class RelationData:
    """The fusion graph: entities + relations (reference RelationData [HIGH]).

    Construction mirrors the reference's main ctor: from a single sparse
    matrix with optional per-mode side info, or built up with
    ``add_relation`` for multi-relation graphs.
    """

    def __init__(self, entities: Optional[Sequence[Entity]] = None,
                 relations: Optional[Sequence[Relation]] = None):
        self.entities: List[Entity] = list(entities or [])
        self.relations: List[Relation] = list(relations or [])

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_matrix(cls, m, feat1: FeatureMatrix = None,
                    feat2: FeatureMatrix = None,
                    names: Tuple[str, str] = ("ent1", "ent2"),
                    relation_name: str = "rel",
                    class_cut: Optional[float] = None) -> "RelationData":
        """RelationData(X; feat1=..., feat2=...) equivalent."""
        if hasattr(m, "tocoo"):
            df = IndexedDF.from_scipy(m)
        elif isinstance(m, IndexedDF):
            df = m
        else:
            df = IndexedDF.from_dense(np.asarray(m))
        e1 = Entity(names[0], count=df.shape[0], F=feat1)
        e2 = Entity(names[1], count=df.shape[1], F=feat2)
        rel = Relation(df, relation_name, [e1, e2], class_cut=class_cut)
        return cls([e1, e2], [rel])

    @classmethod
    def from_indexed_df(cls, df: IndexedDF,
                        entities: Optional[Sequence[Entity]] = None,
                        relation_name: str = "rel",
                        class_cut: Optional[float] = None) -> "RelationData":
        if entities is None:
            entities = [Entity(f"ent{d+1}", count=df.shape[d])
                        for d in range(df.arity)]
        rel = Relation(df, relation_name, entities, class_cut=class_cut)
        return cls(list(entities), [rel])

    # -- graph building (addRelation! [HIGH name]) --------------------------
    def add_relation(self, df: IndexedDF, name: str,
                     entities: Sequence[Entity],
                     class_cut: Optional[float] = None) -> Relation:
        rel = Relation(df, name, entities, class_cut=class_cut)
        for e in entities:
            if e not in self.entities:
                self.entities.append(e)
        self.relations.append(rel)
        return rel

    # -- knobs (setPrecision! [HIGH name]) ----------------------------------
    def set_precision(self, relation: Union[Relation, int, str],
                      alpha: float, sample: bool = False) -> None:
        rel = self._rel(relation)
        rel.model.alpha = float(alpha)
        rel.model.alpha_sample = bool(sample)

    def _rel(self, r: Union[Relation, int, str]) -> Relation:
        if isinstance(r, Relation):
            return r
        if isinstance(r, int):
            return self.relations[r]
        for rel in self.relations:
            if rel.name == r:
                return rel
        raise KeyError(r)

    # -- test split (assignToTest! [HIGH name], SURVEY §4.8) ----------------
    def assign_to_test(self, relation: Union[Relation, int, str],
                       n_or_rows: Union[int, np.ndarray],
                       seed: int = 0) -> None:
        """Move n random observed entries (or the given rows) to the test set."""
        rel = self._rel(relation)
        df = rel.data
        if np.isscalar(n_or_rows) or np.ndim(n_or_rows) == 0:
            n = int(n_or_rows)
            if n > df.nnz:
                raise ValueError("test size exceeds nnz")
            rng = np.random.default_rng(seed)
            rows = rng.choice(df.nnz, size=n, replace=False)
        else:
            rows = np.asarray(n_or_rows, np.int64)
        rows = np.sort(rows)
        rel.set_test(df.idx[rows], df.vals[rows])
        rel.data = df.remove_samples(rows)

    def __repr__(self):
        return (f"RelationData(entities={[e.name for e in self.entities]}, "
                f"relations={self.relations})")
