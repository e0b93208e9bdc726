"""Lagrangian predictability lifetime: the lead time at which a decaying
correlation curve crosses 1/e, or its integral (counterpart of
``pysteps_tpu/verification/lifetime.py``).  Host numpy."""

import numpy as np


def lifetime(X_s, X_t, rule="1/e"):
    """One-shot lifetime of the curve ``X_s`` over lead times ``X_t``."""
    life = lifetime_init(rule)
    lifetime_accum(life, np.asarray(X_s, float), np.asarray(X_t, float))
    return lifetime_compute(life)


def lifetime_init(rule="1/e"):
    """An empty state; ``rule`` is "1/e", "trapz" or "simpson"."""
    if rule not in ("trapz", "simpson", "1/e"):
        raise ValueError(f"Unknown rule {rule} for integration")
    return {"lifetime_sum": 0.0, "n": 0.0, "rule": rule}


def lifetime_accum(lifetime, X_s, X_t):
    """Add one curve's lifetime."""
    X_s = np.asarray(X_s, float)
    X_t = np.asarray(X_t, float)
    rule = lifetime["rule"]
    if rule == "1/e":
        thr = 1.0 / np.e
        if np.all(X_s > thr):
            lf = X_t.max()
        elif np.all(X_s < thr):
            lf = X_t.min()
        else:
            idx = np.where(X_s < thr)[0][0]
            if idx == 0:
                lf = X_t[0]
            else:
                x0, x1 = X_s[idx - 1], X_s[idx]
                t0, t1 = X_t[idx - 1], X_t[idx]
                lf = t0 + (thr - x0) * (t1 - t0) / (x1 - x0)
    elif rule == "trapz":
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        lf = trapezoid(np.clip(X_s, 0, None), x=X_t)
    else:  # simpson
        from scipy.integrate import simpson

        lf = simpson(np.clip(X_s, 0, None), x=X_t)
    lifetime["lifetime_sum"] += float(lf)
    lifetime["n"] += 1


def lifetime_compute(lifetime):
    """The mean lifetime over the accumulated curves."""
    return 1.0 * lifetime["lifetime_sum"] / max(lifetime["n"], 1.0)
