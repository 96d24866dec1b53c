"""Typed configuration for the Gibbs engine.

The reference exposes everything as keyword arguments on ``macau()`` plus
mutable fields on Entity/Relation (``setPrecision!`` etc.) — see SURVEY.md §7.6
(reference: src/macau.jl, kwarg set [MED]).  Here those knobs live in one
dataclass so the compiled sweep is parameterized statically.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class MacauConfig:
    """Engine configuration.

    Mirrors ``macau(rd; num_latent, burnin, psamples, clamp, verbose, ...)``
    from the reference (src/macau.jl, SURVEY.md §4.6) plus device-layout knobs
    that have no reference counterpart.
    """

    num_latent: int = 10
    burnin: int = 500
    psamples: int = 200
    # Clamp predictions (per posterior sample, before averaging — SURVEY §4.7)
    clamp: Optional[Tuple[float, float]] = None
    verbose: bool = True
    seed: int = 1234

    # --- priors / hyperparameters (SURVEY §4.1) ---
    # Normal-Wishart hyperprior: mu0=0, b0=2, W0=I, nu0=K
    nw_b0: float = 2.0
    # nu0 defaults to num_latent (set at compile time if None)
    nw_nu0: Optional[float] = None
    # Link-matrix regularizer lambda_beta: initial value + Gamma hyperprior
    lambda_beta: float = 1.0
    sample_lambda_beta: bool = True
    nu_beta: float = 1e-3          # weak Gamma hyperprior strength [MED]
    lambda_beta_mean: float = 1.0  # prior mean of lambda_beta [MED]
    # Noise precision alpha: fixed 5.0 by default; optional Gamma sampling
    alpha: float = 5.0
    alpha_sample: bool = False
    alpha_a0: float = 1e-3
    alpha_b0: float = 1e-3

    # --- init ---
    init_std: float = 0.3  # latent init scale: U ~ init_std * N(0, I) [LOW]

    # --- numerics ---
    dtype: str = "float32"      # compute dtype ("float64" for CPU oracle-equivalence)
    chol_jitter: float = 0.0    # added to diag of per-row precision before Cholesky
    # Gramian gather/contraction dtype: None = compute dtype; "bfloat16"
    # halves gather HBM traffic (accumulation stays f32)
    gram_dtype: Optional[str] = None
    # Dense Gramian (ops/dense_gram.py): replace the per-observation
    # gather with M @ Y matmuls on relations dense enough that the matmul
    # wins.  None = auto heuristic (measured machine constants in
    # ops/dense_gram.py; only fires at nnz >= 50k), False = never,
    # True = wherever memory allows.
    dense_gram: Optional[bool] = None
    # Device-memory allowance for dense M/W pairs.  A setting, not a
    # measurement of the device: it fixes which path each relation takes
    # (the sharded engine's per-mode pairs fit at ML-10M scale, 2 x 3.06
    # GB bf16; Netflix-shaped pairs do not and take the fused path);
    # modes that do not fit fall back to the gather path (logged to
    # stderr).
    dense_gram_budget_gb: float = 9.0
    # s8 path for dense modes: store M/W as int8 (exact counts;
    # statically-scaled values) and quantize Y/V per sweep with
    # per-output-column scales (ops/dense_gram.quantize_dense_pair).
    # The largest partner axis contracts as an exact s8xs8->int32 dot
    # (half the bf16 operand bytes); tensor relations
    # finish the remaining small axes in f32.  Quantization noise is the
    # same order as gram_dtype="bfloat16"'s rounding.  The gather path is
    # unaffected.
    dense_int8: bool = False
    # Single-array fused dense path (ops/dense_gram.fused_gram_contrib):
    # for arity-2 relations whose values sit on an exact small-integer
    # grid (ratings, binary labels) and whose M/W pair exceeds the HBM
    # budget, store ONE int8 value matrix and derive the observation mask
    # on the fly inside the chunked contraction — half the pair's
    # footprint, exact values.  None = auto (engage exactly when the pair
    # path cannot fit but the single array can — the Netflix-shaped
    # sparse regime), False = never, True = wherever encodable
    # (test/ablation knob).  With dense_int8=True the fused contraction
    # additionally quantizes the per-sweep partner operands to int8
    # (fused_gram_contrib_i8: exact int32 dots, same per-column-scale
    # scheme and PD safety ridge as the pair path); without it the
    # partner operands stay in gram_dtype and the path is quantization-
    # free.
    dense_fused: Optional[bool] = None
    # Bounded-error admission for the fused path (opt-in; VERDICT r3 #2):
    # values with no exact <=255-level grid (continuous pIC50s, float
    # scores) are rounded onto the finest uniform grid that fits the int8
    # code range IF its max rounding error s/2 <= dense_fused_tol — an
    # absolute value-error contract (the error enters only the latent
    # conditional's rhs; alpha sampling and prediction keep exact
    # values).  None = exact grids only.  Duplicate observations and
    # zero-code levels never need this knob: they ride a gather-path
    # residual with exact values (ops/dense_gram.fused_pair_plan).
    dense_fused_tol: Optional[float] = None

    # --- beta solver (SURVEY §4.4) ---
    use_ff: Optional[bool] = None  # None = auto: direct X'X path iff F <= ff_threshold
    ff_threshold: int = 4096
    # When the FF path does not apply: None = auto (Woodbury "dual" exact
    # solver via a one-time eigendecomposition of XX' when N < F and Q
    # fits dual_budget_gb — ops/dual.py; else blocked CG), or force
    # "cg" / "dual".
    beta_solver: Optional[str] = None
    # device-memory allowance for the [N, N] Q + G pair (a setting that
    # fixes the solver choice, not a measurement of the device)
    dual_budget_gb: float = 4.0
    # Directory for caching the one-time XX' eigendecomposition (~270 s
    # host eigh at N=15k) keyed by a content hash of the feature matrix;
    # None = recompute every engine build
    dual_cache_dir: Optional[str] = None
    # Iterative-refinement steps for the dual solve: the f32 eigenbasis
    # carries backward error ~eps*kappa; one step (two extra X passes +
    # one dual apply) recovers the true residual to below CG's f32 floor
    dual_refine: int = 1
    cg_tol: float = 1e-6
    cg_maxiter: int = 200
    # Nystrom-preconditioned CG (ops/precond.py): rank of the one-time
    # randomized X'X factorization.  None (default) = auto: rank 512 when
    # the CG path runs with F >= 8192 (ChEMBL bench shape: 32 -> 21
    # iterations; the one-time host build is seconds).  0 = plain Jacobi.
    # Auto-skipped when F < 4x the rank.
    cg_nystrom_rank: Optional[int] = None

    # --- device layout (no reference counterpart; SURVEY §9.0) ---
    bucket_widths: Sequence[int] = (8, 16, 32, 64, 128, 256, 512, 1024, 2048)
    # Gramian-row accumulation: "segment" = one 2D-flat segment_sum;
    # "planned" = static first-row gather + overflow
    # (see ops/gramian.py)
    accumulation: str = "segment"
    # sharded engine: sample/exchange the local shard in this many chunks so
    # block b's all-gather overlaps block b+1's Cholesky-sample (SURVEY
    # §7.7).  None = auto (4 blocks when n_dev > 1 and shards are large
    # enough — parallel.sharded.resolve_exchange_blocks); 1 = off.
    exchange_blocks: Optional[int] = None
    # sharded engine: instances with GATHER-PATH degree above this
    # threshold get their observations ROUND-ROBINED across all devices
    # and their Gramian psum-reduced (head-entity splitting, SURVEY §7.7
    # / BASELINE north star).  "auto" = engage when one instance's degree
    # dominates a device's average gather work
    # (parallel.sharded.resolve_head_split); None = off; int = explicit.
    head_split_degree: Union[int, str, None] = "auto"
    row_pad: int = 8  # pad bucket rows to a multiple of this

    # Fetch per-sweep metrics to host every N sweeps (1 = every sweep,
    # the reference behavior). On high-latency device links each fetch
    # syncs the pipeline; raise this for throughput runs.
    metrics_every: int = 1
    # Dispatch up to N sweeps as ONE on-device lax.scan program (1 = one
    # XLA dispatch per sweep, the default).  Removes per-dispatch host
    # latency for small problems; per-sweep metrics still come back for
    # every sweep (stacked, one transfer per chunk).  Chunks break at
    # sweeps that need host-side state (checkpoint/output_prefix/trace).
    sweeps_per_dispatch: int = 1

    # --- aux subsystems (SURVEY §7) ---
    # jsonl structured per-sweep records (§7.5); None = off
    log_file: Optional[str] = None
    # posterior-sample dumping during the psamples phase (§7.4: reference's
    # save-prefix for out-of-matrix prediction); saves {prefix}-sweepNNNN.npz
    output_prefix: Optional[str] = None
    # jax.profiler trace directory for one profiled sweep (§7.1); None = off
    trace_dir: Optional[str] = None
    # periodic state snapshot for failure recovery (§7.3): every N sweeps
    # write {checkpoint_path}; 0 = off.  Resume via MacauEngine.load_state.
    checkpoint_every: int = 0
    checkpoint_path: Optional[str] = None

    def __post_init__(self):
        if self.accumulation not in ("segment", "planned"):
            raise ValueError(f"unknown accumulation {self.accumulation!r}")

    def np_dtype(self):
        return np.dtype(self.dtype)

    def resolved_nu0(self) -> float:
        return float(self.num_latent if self.nw_nu0 is None else self.nw_nu0)

    # -- file-based config (SURVEY §7.6: kwargs in the reference; YAML here
    # for production runs) --------------------------------------------------
    @classmethod
    def from_yaml(cls, path: str) -> "MacauConfig":
        import yaml
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        for k in ("clamp", "bucket_widths"):
            if k in data and data[k] is not None:
                data[k] = tuple(data[k])
        return cls(**data)

    def to_yaml(self, path: str) -> None:
        import yaml
        d = dataclasses.asdict(self)
        d["clamp"] = list(self.clamp) if self.clamp else None
        d["bucket_widths"] = list(self.bucket_widths)
        with open(path, "w") as f:
            yaml.safe_dump(d, f, sort_keys=False)
