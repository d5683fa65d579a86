"""Integer least-squares ambiguity resolution (the LAMBDA step).

RTKLIB resolves the double-difference carrier ambiguities of the
reference's rtk/ validation datasets with the LAMBDA method: minimize
(a − z)ᵀ Q⁻¹ (a − z) over integer vectors z, where a is the float
ambiguity estimate and Q its covariance. Plain per-component rounding
fails exactly when it matters — over a short static window the
position and ambiguity errors are near-collinear, so individual
ambiguities have ~cycle-level uncertainty even though *combinations*
of them are known to millimeters. Integer least squares searches the
lattice under the full metric and recovers them.

Implementation: reduce the problem to a closest-vector search. With
W = Q⁻¹ = RᵀR (Cholesky), the objective is ‖R z − R a‖²: a CVP in the
lattice spanned by the columns of R. The basis is LLL-reduced (integer
column operations tracked in a unimodular U), re-triangularized by QR,
and enumerated depth-first with radius pruning (Schnorr–Euchner
ordering), returning the best few candidates for RTKLIB-style ratio
validation. Exactness is testable by brute force on small cases
(tests/test_receiver_rtk.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _lll(B: np.ndarray, delta: float = 0.75) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """LLL-reduce the columns of B; returns (B·U, U) with U unimodular.

    The Gram-Schmidt state (mu, ‖b*‖²) is maintained incrementally under
    size-reduction and swap (Cohen, Alg. 2.6.3) — O(n) per update instead
    of a full O(n³) re-orthogonalization, which matters when cycle slips
    inflate the ambiguity dimension (receiver/rtk.py)."""
    B = B.astype(np.float64).copy()
    n = B.shape[1]
    U = np.eye(n, dtype=np.int64)

    # Initial Gram-Schmidt: mu[i, j<i] projections, nrm[i] = ‖b*_i‖².
    Bs = np.zeros_like(B)
    mu = np.zeros((n, n))
    nrm = np.zeros(n)
    for i in range(n):
        v = B[:, i].copy()
        for j in range(i):
            mu[i, j] = (B[:, i] @ Bs[:, j]) / nrm[j]
            v -= mu[i, j] * Bs[:, j]
        Bs[:, i] = v
        nrm[i] = v @ v

    def red(k, j):
        """Size-reduce b_k against b_j: b*_i are all invariant; only
        row k of mu changes (and only columns <= j)."""
        q = int(round(mu[k, j]))
        if q:
            B[:, k] -= q * B[:, j]
            U[:, k] -= q * U[:, j]
            mu[k, :j] -= q * mu[j, :j]
            mu[k, j] -= q

    k = 1
    while k < n:
        red(k, k - 1)
        if nrm[k] < (delta - mu[k, k - 1] ** 2) * nrm[k - 1]:
            # Swap b_{k-1} <-> b_k; closed-form GS update (only rows/
            # columns k-1, k of mu and those two norms change).
            m = mu[k, k - 1]
            bp = nrm[k] + m * m * nrm[k - 1]
            mu_new = m * nrm[k - 1] / bp
            nrm[k] = nrm[k - 1] * nrm[k] / bp
            nrm[k - 1] = bp
            B[:, [k - 1, k]] = B[:, [k, k - 1]]
            U[:, [k - 1, k]] = U[:, [k, k - 1]]
            mu[[k - 1, k], :k - 1] = mu[[k, k - 1], :k - 1]
            t = mu[k + 1:, k].copy()
            mu[k + 1:, k] = mu[k + 1:, k - 1] - m * t
            mu[k + 1:, k - 1] = t + mu_new * mu[k + 1:, k]
            mu[k, k - 1] = mu_new
            k = max(k - 1, 1)
        else:
            for j in range(k - 2, -1, -1):
                red(k, j)
            k += 1
    return B, U


def _cvp(R: np.ndarray, y: np.ndarray, n_cand: int) -> Tuple[np.ndarray,
                                                             np.ndarray]:
    """Closest lattice vectors: minimize ‖R z − y‖² over integer z.

    R upper triangular with nonzero diagonal. Depth-first enumeration
    from the last coordinate, children visited in Schnorr–Euchner
    (nearest-first zig-zag) order, pruned at the current n_cand-th-best
    radius. Returns (candidates [n_cand, n], squared distances), best
    first.
    """
    n = R.shape[1]
    best: list[tuple[float, tuple]] = []   # (dist², z)
    radius = np.inf
    z = np.zeros(n, dtype=np.int64)

    def recurse(i: int, part: float, y_res: np.ndarray):
        nonlocal radius, best
        if i < 0:
            best.append((part, tuple(z)))
            best.sort(key=lambda t: t[0])
            del best[n_cand:]
            if len(best) == n_cand:
                radius = best[-1][0]
            return
        c = y_res[i] / R[i, i]
        zi = int(np.floor(c + 0.5))
        step = 1 if c >= zi else -1
        for _ in range(64):  # SE zig-zag; pruning terminates it early
            d = part + (R[i, i] * (zi - c)) ** 2
            if d > radius:
                break
            z[i] = zi
            recurse(i - 1, d, y_res - zi * R[:, i])
            zi, step = zi + step, -step - (1 if step > 0 else -1)
        # zig-zag sequence: zi0, zi0±1, zi0∓1, zi0±2, ... implemented via
        # step flipping with growth in the line above.

    recurse(n - 1, 0.0, y.astype(np.float64).copy())
    cands = np.array([b[1] for b in best], dtype=np.int64)
    dists = np.array([b[0] for b in best])
    return cands, dists


def ils_solve(a_float: np.ndarray, Q: np.ndarray,
              n_cand: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """Integer least squares: best integer candidates for
    min (a − z)ᵀ Q⁻¹ (a − z), best first, with their objective values."""
    n = len(a_float)
    W = np.linalg.inv(Q)
    W = 0.5 * (W + W.T)
    R0 = np.linalg.cholesky(W).T          # W = R0ᵀ R0, R0 upper
    Bred, U = _lll(R0)
    # Re-triangularize the reduced basis; CVP target in the same frame.
    Qf, Rf = np.linalg.qr(Bred)
    # Make the diagonal positive for the enumeration.
    sgn = np.sign(np.diag(Rf))
    sgn[sgn == 0] = 1.0
    Rf = sgn[:, None] * Rf
    y = sgn * (Qf.T @ (R0 @ a_float))
    zred, dists = _cvp(Rf, y, n_cand)
    cands = (U @ zred.T).T
    return cands, dists
