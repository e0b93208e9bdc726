"""The numbers that decide ``correct``: the program's output against the
plain reference's on the same inputs and seeds.

Each member's field at each lead is scored by its mean absolute
difference over the pixels finite on either side, each pixel's
difference counted up to ``CAP`` of the reference's span (its largest
finite value less its smallest, over the whole forecast), as a share of
that span; a pixel finite on one side only (the domain's outside, which
the warp fills with NaN) counts the cap.  The cap is there because the
CDF match is discontinuous where the target's values jump from dry to
wet: a pixel whose rank lies at that jump takes a value 4-5 dB away on
either side of it, so two sound programs that differ by rounding differ
there by the jump in a few dozen pixels of a field, more than a rounding
of every pixel adds up to; capped, those pixels weigh what a
quarter-percent error would.

``field_gap``: the worst of these scores, over every member and lead, so
that one member altered alone shows.  ``member_p75_gap``: at each lead the
75th percentile of the members' scores, the worst lead; steady from seed
to seed, it shows a drift of the whole ensemble that stays under
``field_gap``'s limit.

Diagnostics beside them, not held to a limit: where the worst field is,
how many fields score above 1e-5, the worst field's score without the cap
(``uncapped_field_gap``) and how many pixels differ by more than the cap.
"""

import torch

QUANTILE = 0.75
CAP = 0.0025  # of the span: 0.1 dB of a 40 dB span


def field_numbers(out, ref):
    """{"field_gap", "member_p75_gap"} and the diagnostics of two (E, T,
    m, n) forecasts on one device."""
    out, ref = out.double(), ref.double()
    bad = {"field_gap": float("inf"), "member_p75_gap": float("inf")}
    if out.shape != ref.shape:
        return {**bad, "worst": f"shape {tuple(out.shape)}"}
    fin_o, fin_r = torch.isfinite(out), torch.isfinite(ref)
    vals = ref[fin_r]
    if vals.numel() == 0:
        return {**bad, "worst": "no finite reference pixel"}
    span = float(vals.max() - vals.min())
    if not span > 0:
        return {**bad, "worst": "the reference has no span"}
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    diff = (torch.where(fin_o & fin_r, (out - ref).abs(), zero)
            + torch.where(fin_o ^ fin_r, span, zero))
    count = (fin_o | fin_r).sum(dim=(-2, -1)).clamp(min=1) * span
    gap = diff.clamp(max=CAP * span).sum(dim=(-2, -1)) / count
    per_lead = torch.quantile(gap, QUANTILE, dim=0)  # (T,)
    worst = int(torch.argmax(gap))
    T = out.shape[1]
    return {"field_gap": float(gap.flatten()[worst]),
            "member_p75_gap": float(per_lead.max()),
            "worst": f"member {worst // T} lead {worst % T + 1}",
            "fields_over_1e-5": int((gap > 1e-5).sum()),
            "uncapped_field_gap": float((diff.sum(dim=(-2, -1)) / count).max()),
            "pixels_over_cap": int((diff > CAP * span).sum()),
            "one_side_pixels": int((fin_o ^ fin_r).sum())}

