"""Apparent indel-load estimator (calibration honesty, VERDICT r4 #8).

`--ani-semantics skani-calibrated` shifts thresholds by a FIXED typical
indel load (defaults.CALIBRATION_INDEL_EVENTS_PER_SUB at mean indel
length defaults.CALIBRATION_MEAN_INDEL_LEN); real corpora vary. This
module estimates the corpus's own apparent load from the verify
stage's fragment-identity distribution so users can see when the
default is off (reported in --metrics-json and the log; advisory
only — it never changes thresholds).

Signal. Within one genome pair, mutation events hit fragments as a
Poisson process; an event destroys ~k k-mer windows if it is a
substitution and ~k+len-1 if it is an indel (the same window
arithmetic behind the calibrated threshold shift,
tests/test_estimator_stress.py::test_indel_bias_matches_theory). Both
lower the MEAN fragment identity, but indels' larger per-event marks
make the per-fragment identity distribution MORE DISPERSED at the
same mean — so the dispersion

    r_obs = var(d) / mean(d) * W * k     (d = 1 - identity per fragment)

separates the event mix even though no single fragment does.

Inversion. The naive mapping r = E[M^2]/E[M] overstates dispersion:
at real divergences the destroyed windows of different events OVERLAP
and clip the variance (measured: r ~ 9 where mark arithmetic says 15
for pure substitutions at 0.5% divergence), and the sketch's
window subsampling adds binomial noise. Rather than correcting
analytically, the estimator inverts r through a Monte-Carlo model of
the SAME measurement process — Poisson events with geometric indel
lengths, interval union on the window line, binomial window
subsampling, identity = survival^(1/k) — matched to each
pair-direction's observed mean divergence and hash counts, with
common random numbers across the bisection so the inversion is
smooth. What the MC does not model (between-fragment rate
heterogeneity from recombination tracts or HGT islands) inflates
r_obs, so on real corpora the estimate leans HIGH: treat it as a
"the fixed default is clearly off" alarm, not a precise rate.
Reference semantics being diagnosed: gap-excluded skani ANI
(the reference galah's src/skani.rs:718-788) vs this engine's
event-inclusive window ANI.

The port's own copy of galah_tpu/ops/indel_estimate.py, so that the port
imports nothing of galah_tpu: same behaviour, file formats and numerics.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from galah_tpu_torch import defaults


def _fragment_densities(
    query_sketch, ref_sketch, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-fragment (mismatch density d = 1 - identity, hash count) for
    query fragments against the ref membership set — the host-side
    mirror of the verify kernels' fragment containment."""
    member = np.asarray(ref_sketch.member_buckets)
    fb = np.asarray(query_sketch.frag_buckets)
    off = np.asarray(query_sketch.frag_offsets)
    if len(member) == 0 or len(fb) == 0:
        z = np.empty(0)
        return z, z
    pos = np.searchsorted(member, fb)
    hit = (pos < len(member)) & (
        member[np.minimum(pos, len(member) - 1)] == fb
    )
    ds, ns = [], []
    inv_k = 1.0 / k
    for f in range(len(off) - 1):
        lo, hi = int(off[f]), int(off[f + 1])
        n = hi - lo
        if n < 16:
            continue
        c = float(hit[lo:hi].mean())
        if c <= 0.0:
            continue  # unrelated fragment: not this pair's mutation signal
        ds.append(1.0 - c ** inv_k)
        ns.append(n)
    return np.asarray(ds), np.asarray(ns, dtype=np.float64)


def _simulate_r(
    p: float,
    q_cover: float,
    W: int,
    n_keep: float,
    k: int,
    mean_len: float,
    rng: np.random.Generator,
    trials: int = 4096,
) -> float:
    """Dispersion r of the simulated measurement at indel event
    fraction p, window-coverage q_cover, W windows per fragment and
    n_keep subsampled windows — the generative mirror of
    _fragment_densities (interval union + binomial subsample +
    identity transform)."""
    e_mark = (1.0 - p) * k + p * (k + mean_len - 1.0)
    lam = -W * np.log(max(1.0 - q_cover, 1e-9)) / e_mark
    counts = rng.poisson(lam, trials)
    total = int(counts.sum())
    if total == 0:
        return float(k)
    frag = np.repeat(np.arange(trials), counts)
    pos = rng.integers(0, W, total)
    is_ind = rng.random(total) < p
    marks = np.where(
        is_ind, k + rng.geometric(1.0 / max(mean_len, 1.0), total) - 1, k
    )
    end = np.minimum(pos + marks, W)
    acc = np.zeros((trials, W + 1), np.int16)
    np.add.at(acc, (frag, pos), 1)
    np.add.at(acc, (frag, end), -1)
    covered = acc.cumsum(axis=1)[:, :W] > 0
    sel = rng.random((trials, W)) < (n_keep / W)
    nsel = sel.sum(axis=1)
    ok = nsel >= 16
    c = ((~covered) & sel).sum(axis=1)[ok] / nsel[ok]
    c = np.maximum(c, 1e-9)
    d = 1.0 - c ** (1.0 / k)
    m = float(d.mean())
    if m <= 0:
        return float(k)
    return float(d.var(ddof=1) / m * W * k)


def estimate_indel_load(
    pairs: Sequence[Tuple[int, int]],
    sketch_for,
    params,
    max_pairs: int = 48,
    min_fragments: int = 64,
    min_directions: int = 6,
    seed: int = 0,
) -> Optional[Dict[str, float]]:
    """Estimate the corpus's apparent indel load from verified pairs.

    pairs: (i, j) index pairs that passed verification (both directions
    are measured); sketch_for(i) -> NativeSketch. Returns None when
    too few directions carry signal (the per-direction dispersion is
    heavy-tailed, so a robust median over >= min_directions is the
    unit of inference). Result dict:

    - dispersion_excess: pooled r_obs / MC r(p=0) — the primary
      alarm. ~1.0 means the identity dispersion is consistent with
      substitutions (+ light indels, which this statistic cannot
      resolve from them); >~1.2 means a heavy large-mark load (long
      indels, deletion bias, rearrangement tracts) for which the
      fixed calibration default is clearly off.
    - apparent_indel_events_per_sub: the excess inverted through the
      MC at the DOCUMENTED mean indel length; saturates (clamped to
      <= 9) when the excess exceeds what length-3 indels can produce.
      Resolution is coarse (~0.5 at typical shapes): light loads in
      the 0-0.3 band the calibration default targets read as ~0-noise.
    - mark_ratio (pooled r_obs), pairs_used (directions),
      fragments_used, calibration_default."""
    k = params.k
    mean_len = defaults.CALIBRATION_MEAN_INDEL_LEN
    W = params.fragment_length - k + 1
    obs = []  # (r_obs, mean_d, n_keep_mean, n_frags)
    for i, j in list(pairs)[:max_pairs]:
        for a, b in ((i, j), (j, i)):
            d, n = _fragment_densities(sketch_for(a), sketch_for(b), k)
            if len(d) < min_fragments:
                continue
            mean_d = float(d.mean())
            # Enough events for dispersion to mean anything, but below
            # the saturating coverage where variance clips to nothing.
            if not (1e-3 <= mean_d <= 0.02):
                continue
            r = float(d.var(ddof=1)) / mean_d * W * k
            obs.append((r, mean_d, float(n.mean()), len(d)))
    if len(obs) < min_directions:
        return None
    # Robust pooling FIRST (the per-direction variance estimator has
    # heavy tails — compound-Poisson kurtosis makes single directions
    # swing 2x), then ONE MC inversion at the pooled operating point.
    r_obs = float(np.median([o[0] for o in obs]))
    mean_d = float(np.median([o[1] for o in obs]))
    n_keep = float(np.median([o[2] for o in obs]))
    frags_used = sum(o[3] for o in obs)
    q_cover = 1.0 - (1.0 - mean_d) ** k

    def r_at(p):
        # Common random numbers across the bisection: same generator
        # seed, so r(p) is a smooth monotone function of p.
        rng = np.random.default_rng(seed)
        return _simulate_r(
            p, q_cover, W, n_keep, k, mean_len, rng, trials=8192
        )

    r0 = r_at(0.0)
    lo_p, hi_p = 0.0, 0.9
    if r_obs <= r0:
        p_hat = 0.0
    elif r_obs >= r_at(hi_p):
        p_hat = hi_p
    else:
        for _ in range(7):
            mid = 0.5 * (lo_p + hi_p)
            if r_at(mid) < r_obs:
                lo_p = mid
            else:
                hi_p = mid
        p_hat = 0.5 * (lo_p + hi_p)
    return {
        "apparent_indel_events_per_sub": p_hat / (1.0 - p_hat),
        "dispersion_excess": r_obs / max(r0, 1e-9),
        "mark_ratio": r_obs,
        "pairs_used": float(len(obs)),
        "fragments_used": float(frags_used),
        "calibration_default": defaults.CALIBRATION_INDEL_EVENTS_PER_SUB,
    }
