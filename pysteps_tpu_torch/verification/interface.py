"""Verification-method registry (counterpart of
``pysteps_tpu/verification/interface.py``): the same names by type, the
same errors."""

from pysteps_tpu_torch.verification import (
    detcatscores,
    detcontscores,
    ensscores,
    probscores,
    spatialscores,
)

CATEGORICAL = {
    "acc", "bias", "csi", "f1", "fa", "far", "gss", "ets", "hk", "hss", "mcc", "pod", "sedi",
}
CONTINUOUS = {
    "me", "mae", "mse", "rmse", "nmse", "drmse", "beta", "beta1", "beta2", "corr_p",
    "corr_s", "rv", "scatter",
}


def get_method(name, type="deterministic"):
    """The verification function ``name`` of ``type`` ("deterministic",
    "ensemble", or "probabilistic" / "prob")."""
    if name is None:
        name = "none"
    if type is None:
        type = "none"
    name, type = name.lower(), type.lower()

    if type == "deterministic":
        if name == "beta":  # the alias of the slope beta1
            name = "beta1"
        if name in CATEGORICAL:

            def f(fct, obs, **kwargs):
                return detcatscores.det_cat_fct(
                    fct, obs, kwargs.pop("thr", 0.1), scores=name, **kwargs
                )

            return f
        if name in CONTINUOUS:

            def f(fct, obs, **kwargs):
                return detcontscores.det_cont_fct(fct, obs, scores=name, **kwargs)

            return f
        if name == "fss":
            return spatialscores.fss
        if name == "binary_mse" or name == "bmse":
            return spatialscores.binary_mse
        if name == "sal":
            from pysteps_tpu_torch.verification.salscores import sal

            return sal
        raise ValueError(f"unknown deterministic method {name}")

    if type == "ensemble":
        methods = {
            "ens_skill": ensscores.ensemble_skill,
            "ens_spread": ensscores.ensemble_spread,
            "rankhist": ensscores.rankhist,
        }
        if name in methods:
            return methods[name]
        raise ValueError(f"unknown ensemble method {name}")

    if type in ("probabilistic", "prob"):
        methods = {
            "crps": probscores.CRPS,
            "reldiag": probscores.reldiag,
            "roc": probscores.ROC_curve,
        }
        if name in methods:
            return methods[name]
        raise ValueError(f"unknown probabilistic method {name}")

    raise ValueError(f"unknown type {type}")
