"""Offline quality metrics over generated motion.

The port's own copy of ``audio2photoreal_tpu/apps/eval_metrics.py`` (numpy;
reference utils/eval.py:14-108): cross-sample variance, static diversity
var_g, kinematic variance var_k, and static / kinematic FID on 104-d pose.
The FID's matrix square root is ``scipy.linalg.sqrtm`` where scipy is
installed, else an eigendecomposition of the symmetrised product.

    python -m audio2photoreal_tpu_torch.apps.eval_metrics --results <results.npy> [--num_samples N]
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np


def calculate_diversity(
    activation: np.ndarray, diversity_times: int = 10_000, seed: int = 0
) -> np.ndarray:
    """Pairwise distances between random sample pairs (utils/eval.py:14-21)."""
    assert activation.ndim == 2
    n = activation.shape[0]
    times = min(diversity_times, n - 1)
    rng = np.random.RandomState(seed)
    first = rng.choice(n, times, replace=False)
    second = rng.choice(n, times, replace=False)
    return np.linalg.norm(activation[first] - activation[second], axis=1)


def activation_statistics(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return acts.mean(axis=0), np.cov(acts, rowvar=False)


def _sqrtm_psd(m: np.ndarray) -> np.ndarray:
    """Matrix square root via eigh after symmetrization."""
    sym = (m + m.T) / 2.0
    vals, vecs = np.linalg.eigh(sym)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians (utils/eval.py:32-76)."""
    diff = mu1 - mu2
    prod = sigma1 @ sigma2
    try:
        from scipy import linalg as _sla  # optional; exact for non-normal products

        covmean, _ = _sla.sqrtm(prod, disp=False)
        if not np.isfinite(covmean).all():
            offset = np.eye(sigma1.shape[0]) * eps
            covmean = _sla.sqrtm((sigma1 + offset) @ (sigma2 + offset))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
    except ImportError:
        covmean = _sqrtm_psd(prod)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def evaluate_results(
    pred: np.ndarray,  # [num_samples, N, C, T] or flat equivalents
    gt: np.ndarray,
    nfeats: int = 104,
) -> Dict[str, float]:
    """The full metric block of utils/eval.py:77-108 as a function."""
    num_samples = pred.shape[0]
    cross_var = np.var(pred.reshape(num_samples, -1), axis=0).mean()

    pred_last = pred.transpose(0, 1, 3, 2).reshape(-1, nfeats)
    gt_last = gt.transpose(0, 1, 3, 2).reshape(-1, nfeats)
    var_g = calculate_diversity(pred_last).mean()
    var_k = np.var(pred, axis=-1).mean()

    mu_p, cov_p = activation_statistics(pred_last)
    mu_g, cov_g = activation_statistics(gt_last)
    fid_g = frechet_distance(mu_g, cov_g, mu_p, cov_p)

    pred_vel = pred[..., 1:] - pred[..., :-1]
    gt_vel = gt[..., 1:] - gt[..., :-1]
    mu_pk, cov_pk = activation_statistics(pred_vel.transpose(0, 1, 3, 2).reshape(-1, nfeats))
    mu_gk, cov_gk = activation_statistics(gt_vel.transpose(0, 1, 3, 2).reshape(-1, nfeats))
    fid_k = frechet_distance(mu_gk, cov_gk, mu_pk, cov_pk)

    return {
        "cross_var": float(cross_var),
        "var_g": float(var_g),
        "var_k": float(var_k),
        "fid_g": fid_g,
        "fid_k": fid_k,
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--results", type=str, required=True)
    parser.add_argument("--num_samples", type=int, default=5)
    parser.add_argument("--nfeats", type=int, default=104)
    parser.add_argument("--seq_len", type=int, default=600)
    args = parser.parse_args()
    results = np.load(args.results, allow_pickle=True).item()
    pred = results["motions"].squeeze().reshape(
        (args.num_samples, -1, args.nfeats, args.seq_len)
    )
    gt = results["gt"].squeeze().reshape((args.num_samples, -1, args.nfeats, args.seq_len))
    for k, v in evaluate_results(pred, gt, args.nfeats).items():
        print(k, v)


if __name__ == "__main__":
    main()
