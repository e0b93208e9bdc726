"""Shared helpers that keep the verification package free of circular
imports (counterpart of ``pysteps_tpu/verification/interface_helpers.py``)."""


def resolve_det_score(metric):
    """The one-shot deterministic score named ``metric``: a continuous
    score, else a categorical one (threshold ``thr``, 0.1 by default)."""
    from pysteps_tpu_torch.verification import detcatscores, detcontscores

    cont = {
        "me", "mae", "mse", "rmse", "nmse", "drmse", "beta1", "beta2",
        "corr_p", "rv", "scatter",
    }
    if metric.lower() in cont:
        return lambda pred, obs, **kw: detcontscores.det_cont_fct(
            pred, obs, scores=metric, **kw
        )
    return lambda pred, obs, thr=0.1, **kw: detcatscores.det_cat_fct(
        pred, obs, thr, scores=metric, **kw
    )
