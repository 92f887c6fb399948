"""Chi-square goodness-of-fit harness for directional sampling routines.

Capability match for include/mitsuba/core/chisquare.h + the
`test_chisquare` plugin (src/tests/test_chisquare.cpp): histogram a
sampling routine over a (theta, phi) grid, integrate the claimed pdf over
the same cells, pool low-count cells, and run the chi-square test at a
given significance (the reference uses 0.0025 with tolerant round-off
bounds).

Batch form: the sampler histogram is one vmapped pass + scatter-add; the pdf
integral uses midpoint quadrature over a finer subgrid (the reference uses
adaptive quadrature; midpoint at 8x subdivision is within the same
tolerance for the smooth pdfs under test).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from scipy.stats import chi2 as _chi2  # scipy ships in the image


@dataclasses.dataclass
class ChiSquareResult:
    passed: bool
    statistic: float
    dof: int
    p_value: float
    pooled_cells: int


def _cell_index(d, res_theta, res_phi):
    theta = jnp.arccos(jnp.clip(d[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 1], d[..., 0]) % (2.0 * jnp.pi)
    it = jnp.clip((theta / jnp.pi * res_theta).astype(jnp.int32), 0,
                  res_theta - 1)
    ip = jnp.clip((phi / (2 * jnp.pi) * res_phi).astype(jnp.int32), 0,
                  res_phi - 1)
    return it * res_phi + ip


def chi2_test(
    sample_fn,
    pdf_fn,
    n_samples: int = 1_000_000,
    res_theta: int = 10,
    res_phi: int = 20,
    significance: float = 0.0025,
    min_exp_count: float = 5.0,
    key=None,
    sub: int = 8,
) -> ChiSquareResult:
    """Test that directions from sample_fn(key, n) ~ pdf_fn(dirs).

    sample_fn(key, n) -> (n, 3) unit directions (may include invalid rows
    flagged by zero vectors, which are dropped); pdf_fn(d) -> solid-angle
    pdf for (n, 3) directions.
    """
    key = jax.random.PRNGKey(7) if key is None else key
    d = np.asarray(sample_fn(key, n_samples))
    ok = np.linalg.norm(d, axis=-1) > 0.5
    d = d[ok]
    n_eff = len(d)
    cells = np.asarray(_cell_index(jnp.asarray(d), res_theta, res_phi))
    counts = np.bincount(cells, minlength=res_theta * res_phi).astype(
        np.float64
    )

    # pdf integral per cell via midpoint quadrature on a sub-grid
    ft = res_theta * sub
    fp = res_phi * sub
    th = (np.arange(ft) + 0.5) / ft * np.pi
    ph = (np.arange(fp) + 0.5) / fp * 2 * np.pi
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    dirs = np.stack(
        [np.sin(TH) * np.cos(PH), np.sin(TH) * np.sin(PH), np.cos(TH)],
        axis=-1,
    ).reshape(-1, 3).astype(np.float32)
    pdf = np.asarray(pdf_fn(jnp.asarray(dirs))).reshape(ft, fp)
    d_area = (np.pi / ft) * (2 * np.pi / fp) * np.sin(TH)
    cell_prob = (pdf * d_area).reshape(
        res_theta, sub, res_phi, sub
    ).sum(axis=(1, 3)).reshape(-1)
    expected = cell_prob * n_eff
    # samplers may discard a fraction of their mass (below-horizon VNDF
    # reflections, Dirac components); test the conditional shape by
    # renormalizing the expectation to the retained count (the reference
    # models rejected samples as an extra bucket — same intent)
    total_p = expected.sum()
    if total_p > 0:
        expected = expected * (n_eff / total_p)

    # pool cells below the minimum expected count (reference behavior)
    order = np.argsort(expected)
    pooled_c = pooled_e = 0.0
    stat = 0.0
    dof = 0
    pooled_cells = 0
    for i in order[::-1]:
        if expected[i] >= min_exp_count:
            stat += (counts[i] - expected[i]) ** 2 / expected[i]
            dof += 1
        else:
            pooled_c += counts[i]
            pooled_e += expected[i]
            pooled_cells += 1
    if pooled_e > min_exp_count:
        stat += (pooled_c - pooled_e) ** 2 / pooled_e
        dof += 1
    dof = max(dof - 1, 1)
    p = float(_chi2.sf(stat, dof))
    return ChiSquareResult(
        passed=p >= significance, statistic=float(stat), dof=dof,
        p_value=p, pooled_cells=pooled_cells,
    )
