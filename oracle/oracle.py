"""Sequential NumPy float64 oracle for the Gibbs engine.

This is the test-strategy oracle from SURVEY.md §9.5 — a slow, obviously
correct, per-row-loop implementation of the algorithmic contract in SURVEY §4
(BPMF: Salakhutdinov & Mnih ICML'08; Macau: Simm et al. MLSP'17).  It stands
in for the unreachable Julia reference runtime: the device engine must
reproduce its per-sweep factor updates to float64 tolerance when both
consume the SAME injected randoms pytree (utils/rng.py draw_all_numpy).

It deliberately shares no code with the engine: gathers go through the
IndexedDF inverted index per row, solves are dense scipy — a genuine
cross-check of the bucketed/vectorized path.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import scipy.linalg as sla

from bayesiandatafusion_jl_tpu.models.data import (RelationData,
                                                   resolved_alpha,
                                                   resolved_alpha_sample,
                                                   resolved_lambda_beta)
from bayesiandatafusion_jl_tpu.utils.config import MacauConfig


class OracleState:
    def __init__(self):
        self.U: List[np.ndarray] = []
        self.mu: List[np.ndarray] = []
        self.Lambda: List[np.ndarray] = []
        self.beta: List[Optional[np.ndarray]] = []
        self.uhat: List[Optional[np.ndarray]] = []
        self.lambda_beta: List[float] = []
        self.alpha: List[float] = []


class OracleMacau:
    """Reference-semantics Gibbs sampler (SURVEY §4), sequential float64."""

    def __init__(self, rd: RelationData, config: MacauConfig):
        self.rd = rd
        self.cfg = config
        self.K = config.num_latent
        self.nu0 = config.resolved_nu0()
        # per relation: centered train values, mean, inverted indexes per mode
        self.mean_value = [float(r.data.vals.mean()) if r.data.nnz else 0.0
                           for r in rd.relations]
        self.inv_index = []
        for r in rd.relations:
            self.inv_index.append([r.data.index(m) for m in range(r.arity)])
        self.ent_of = []
        ent_ids = {id(e): i for i, e in enumerate(rd.entities)}
        for r in rd.relations:
            self.ent_of.append([ent_ids[id(e)] for e in r.entities])
        self.feat_dense = [e.F.to_dense() if e.has_features else None
                           for e in rd.entities]

    # -- init must mirror MacauEngine.init_state given the same U draws -----
    def init_state(self, U_init: List[np.ndarray]) -> OracleState:
        st = OracleState()
        K = self.K
        for ei, e in enumerate(self.rd.entities):
            st.U.append(np.array(U_init[ei], np.float64))
            st.mu.append(np.zeros(K))
            st.Lambda.append(np.eye(K))
            if e.has_features:
                st.beta.append(np.zeros((e.num_features, K)))
                st.uhat.append(np.zeros((e.count, K)))
            else:
                st.beta.append(None)
                st.uhat.append(None)
            # same precedence as the engines (models/data.py resolved_*)
            st.lambda_beta.append(resolved_lambda_beta(e, self.cfg))
        for r in self.rd.relations:
            st.alpha.append(resolved_alpha(r, self.cfg))
        return st

    def sweep(self, st: OracleState, randoms: Dict[str, np.ndarray]) -> None:
        """One in-place Gibbs sweep with injected randoms (SURVEY §4.6)."""
        cfg = self.cfg
        K = self.K
        for ei, ent in enumerate(self.rd.entities):
            U = st.U[ei]
            N = ent.count
            if ent.has_features:
                self._sample_beta(st, ei, randoms)
                if cfg.sample_lambda_beta:
                    b = st.beta[ei]
                    tr = np.trace(b.T @ b @ st.Lambda[ei])
                    rate = (cfg.nu_beta / cfg.lambda_beta_mean + tr) / 2.0
                    st.lambda_beta[ei] = float(randoms[f"e{ei}.lb_g"] / rate)
            S = U - st.uhat[ei] if st.uhat[ei] is not None else U
            st.mu[ei], st.Lambda[ei] = self._normal_wishart(S, ei, randoms)
            # per-row latent conditional (SURVEY §4.2) — plain loop
            mu, Lam = st.mu[ei], st.Lambda[ei]
            xi = randoms[f"e{ei}.xi"]
            Unew = np.empty_like(U)
            for i in range(N):
                P = Lam.copy()
                prior_mean = mu + (st.uhat[ei][i] if st.uhat[ei] is not None
                                   else 0.0)
                b = Lam @ prior_mean
                for ri, rel in enumerate(self.rd.relations):
                    alpha = st.alpha[ri]
                    mv = self.mean_value[ri]
                    for mode in range(rel.arity):
                        if self.ent_of[ri][mode] != ei:
                            continue
                        rows = self.inv_index[ri][mode][i]
                        if len(rows) == 0:
                            continue
                        idx = rel.data.idx[rows]
                        Z = np.ones((len(rows), K))
                        for d in range(rel.arity):
                            if d == mode:
                                continue
                            Z = Z * st.U[self.ent_of[ri][d]][idx[:, d]]
                        v = rel.data.vals[rows] - mv
                        P = P + alpha * (Z.T @ Z)
                        b = b + alpha * (Z.T @ v)
                if cfg.chol_jitter:
                    P = P + cfg.chol_jitter * np.eye(K)
                L = np.linalg.cholesky(P)
                mu_star = sla.cho_solve((L, True), b)
                Unew[i] = mu_star + sla.solve_triangular(
                    L, xi[i], lower=True, trans="T")
            st.U[ei] = Unew
        # noise precisions (SURVEY §4.5)
        for ri, rel in enumerate(self.rd.relations):
            if not resolved_alpha_sample(rel, cfg):
                continue
            idx = rel.data.idx
            Z = np.ones((rel.data.nnz, K))
            for d in range(rel.arity):
                Z = Z * st.U[self.ent_of[ri][d]][idx[:, d]]
            pred_c = Z.sum(axis=1)
            sse = float(np.sum((rel.data.vals - self.mean_value[ri]
                                - pred_c) ** 2))
            rate = cfg.alpha_b0 + sse / 2.0
            st.alpha[ri] = float(randoms[f"r{ri}.alpha_g"] / rate)

    # -- conditionals --------------------------------------------------------
    def _normal_wishart(self, S, ei, randoms):
        cfg = self.cfg
        N, K = S.shape
        Sbar = S.mean(axis=0)
        Sc = S - Sbar
        b_star = cfg.nw_b0 + N
        mu_star = N * Sbar / b_star
        Winv = (np.eye(K) + Sc.T @ Sc
                + (cfg.nw_b0 * N / b_star) * np.outer(Sbar, Sbar))
        M = np.linalg.cholesky(Winv)
        chi2 = 2.0 * randoms[f"e{ei}.nw_g"]
        A = (np.tril(randoms[f"e{ei}.nw_tri"], -1)
             + np.diag(np.sqrt(chi2)))
        BA = sla.solve_triangular(M, A, lower=True, trans="T")  # M^{-T} A
        Lam = BA @ BA.T
        w = sla.solve_triangular(A, randoms[f"e{ei}.nw_mu"], lower=True,
                                 trans="T")
        mu = mu_star + (M @ w) / np.sqrt(b_star)
        return mu, Lam

    def _sample_beta(self, st, ei, randoms):
        """Noise-injected exact draw (SURVEY §4.4), dense direct solve."""
        X = self.feat_dense[ei]
        U, mu, Lam = st.U[ei], st.mu[ei], st.Lambda[ei]
        lam = st.lambda_beta[ei]
        L = np.linalg.cholesky(Lam)

        def colored(z):  # rows ~ N(0, Lambda^{-1})
            return sla.solve_triangular(L, z.T, lower=True, trans="T").T

        E1 = colored(randoms[f"e{ei}.beta_e1"])
        E2 = colored(randoms[f"e{ei}.beta_e2"])
        rhs = X.T @ (U - mu + E1) + np.sqrt(lam) * E2
        A = X.T @ X + lam * np.eye(X.shape[1])
        beta = np.linalg.solve(A, rhs)
        st.beta[ei] = beta
        st.uhat[ei] = X @ beta

    def predict(self, st: OracleState, ri: int, idx: np.ndarray) -> np.ndarray:
        Z = np.ones((idx.shape[0], self.K))
        for d in range(self.rd.relations[ri].arity):
            Z = Z * st.U[self.ent_of[ri][d]][idx[:, d]]
        return self.mean_value[ri] + Z.sum(axis=1)
