"""Time the kernel rows of one checkout of the PyTorch port on inputs saved
once, the way ``chip_smoke.py`` times them, so that two checkouts (a change
and its parent) compare on the same inputs in one run on one card.

    python3 scripts/compare_kernel_times.py --save
    python3 scripts/compare_kernel_times.py --root CHECKOUT --tag NAME [--out FILE]

``--save`` draws the inputs of ``chip_smoke.py``'s phase 3 with this
checkout (path A's last lead recorded from one forecast, for the chain and
the CDF counts; the other rows' inputs from a seed at the shapes of the
path that runs them) and writes them under ``build/`` with ``torch.save``.
``--root`` imports ``pysteps_tpu_torch`` from CHECKOUT (and no other copy
of it), builds its kernels, calls each row's public wrapper on the saved
inputs and prints one JSON line: per row ``ms``, the device time (median
of 5 replays of a CUDA graph of 100 calls, ``chip_smoke.steady_ms``),
``ms_eager`` (median of 5 windows of 100 eager calls) and ``checksum``,
the f64 sum of the finite outputs, which two checkouts of the same
function share.  Run parent, change, change, parent in one call: the
repeats show the spread.  Needs one CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
INPUTS = REPO / "build" / "compare_kernel_times" / "inputs.pt"


def save():
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from pysteps_tpu_torch.ops import pallas_chain, pallas_histmatch, pallas_warp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    leads, a = cs._capture_chain_leads()
    lead = leads[cs.PATH_B[2] - 1]
    disp_bc = max(lead["max_abs_dx"], lead["max_abs_dy"])
    E, mc = cs.N_MEMBERS, cs.SIDE // 4
    fields = torch.randn((2 * E, mc, mc), generator=gen, device=dev)
    disp = cs.smooth_displacements(gen, E, mc, 14.0)
    k1 = {"fields": fields}
    for axis in (0, 1):
        pos = torch.arange(mc, device=dev, dtype=torch.float32)
        c = (pos[:, None] if axis == 0 else pos[None, :]) + disp[:, 1 - axis]
        k1[f"idx0_{axis}"] = torch.floor(c).to(torch.int32).contiguous()
        k1[f"frac_{axis}"] = (c - torch.floor(c)).contiguous()
    out = {"K1": k1}
    for label, (members, side, _) in (("B", cs.PATH_B), ("C", cs.PATH_C)):
        x, (edges, d0, d1, q0, zval, ztrg) = cs.member_luts(gen, members, side)
        d = cs.smooth_displacements(gen, members, side, disp_bc / 1.6)
        row = {"x": x, "dy": d[:, 1].contiguous(),
               "disp_t": d.transpose(-1, -2).contiguous(),
               "scal": (q0, zval, ztrg.expand(members).contiguous())}
        if label == "B":
            row["e8"], row["T"] = pallas_histmatch.pack_gather_lut(edges, d0, d1)
        else:
            row["e16"], row["M3"] = pallas_chain.pack_hier_lut(edges, d0, d1)
        out[label] = row
    x, (edges, d0, d1, q0, _, _) = cs.member_luts(gen, E, cs.SIDE)
    out["A"] = {"mask": x[:1].reshape(1, cs.SIDE, cs.SIDE) >= -10.0,
                "x": x, "edges": edges.contiguous(),
                "w": pallas_histmatch.flat_weights(d0, d1), "q0": q0}
    out["chain"] = dict(a, D=pallas_warp._round8(a["D"]))
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, INPUTS)
    print(json.dumps({"saved": str(INPUTS.relative_to(REPO)),
                      "bytes": INPUTS.stat().st_size}), flush=True)


def rows(inp, pallas_chain, pallas_dilate, pallas_histmatch, pallas_warp):
    """Each row's call on the saved inputs, by ``chip_smoke.py``'s names."""
    nan = float("nan")
    k1, b, c, a, ch = inp["K1"], inp["B"], inp["C"], inp["A"], inp["chain"]
    # path B's LUTs with one fine edge of each member's top block made NaN:
    # they fail the prefix-table check, so the kernel takes the 15-term sum
    b["T_slow"] = b["T"].clone()
    b["T_slow"][:, 7, 14] = float("nan")
    # likewise path C's hierarchical LUTs (the last fine edge of the top
    # block) and the flat LUTs (the last edge): the 7- and 128-term sums
    c["M3_slow"] = c["M3"].clone()
    c["M3_slow"][:, 6, 15] = float("nan")
    a["edges_slow"] = a["edges"].clone()
    a["edges_slow"][:, -1] = float("nan")
    v_args = (ch["field"], ch["e8"], ch["T"], ch["q0"], ch["zval"], ch["ztrg"],
              ch["thr"], ch["dy"], ch["D"], ch["kr"], ch["r"], ch["do_rim"])
    C, _ = pallas_chain.chain_match_vert_rim(*v_args)
    B, m, n = ch["field"].shape
    # every pixel of a member equal to one of its edges: one hot bin
    x_one = ch["edges"][:, 5:6].expand(B, m * n).contiguous()
    ztrg_b = ch["ztrg"].expand(B)

    def unfused():
        matched = pallas_histmatch.pwl_apply_gather(
            ch["field"].reshape(B, -1), ch["e8"], ch["T"], ch["q0"], ch["zval"],
            ztrg_b).reshape(B, m, n)
        pallas_dilate.dilated_rim_from_field(matched, ch["thr"], ch["kr"], ch["r"])
        return pallas_warp.warp_fused(matched, ch["dy"], ch["disp_t"], ch["D"], ch["cval"])

    def side(row):
        members, px = row["x"].shape
        s = int(round(px ** 0.5))
        return row["x"].reshape(members, s, s)

    out = {
        f"K1_resample_axis{axis}": (lambda axis=axis: pallas_warp.axis_resample(
            k1["fields"], k1[f"idx0_{axis}"], k1[f"frac_{axis}"], 12, axis))
        for axis in (0, 1)
    }
    for label, row in (("", b), ("_C", c)):
        f = side(row)
        out["K2_warp" + label] = (lambda f=f, row=row: pallas_warp.warp_fused(
            f, row["dy"], row["disp_t"], 48, nan))
        out["K4_rim_from_field" + label] = (
            lambda f=f: pallas_dilate.dilated_rim_from_field(f, -10.0, 2, 10))
    out.update({
        "K3_pwl_gather": lambda: pallas_histmatch.pwl_apply_gather(
            b["x"], b["e8"], b["T"], *b["scal"]),
        "K3_pwl_gather_slow_lut": lambda: pallas_histmatch.pwl_apply_gather(
            b["x"], b["e8"], b["T_slow"], *b["scal"]),
        "K4_rim_from_mask": lambda: pallas_dilate.dilated_rim(a["mask"], 2, 10),
        "chain_match_vert_rim": lambda: pallas_chain.chain_match_vert_rim(*v_args),
        "chain_horiz": lambda: pallas_chain.chain_horiz(C, ch["disp_t"], ch["D"], ch["cval"]),
        "pwl_hier": lambda: pallas_histmatch.pwl_apply_hier(
            c["x"], c["e16"], c["M3"], *c["scal"]),
        "pwl_hier_slow_lut": lambda: pallas_histmatch.pwl_apply_hier(
            c["x"], c["e16"], c["M3_slow"], *c["scal"]),
        "pwl_flat": lambda: pallas_histmatch.pwl_apply(a["x"], a["edges"], a["w"], a["q0"]),
        "pwl_flat_slow_lut": lambda: pallas_histmatch.pwl_apply(
            a["x"], a["edges_slow"], a["w"], a["q0"]),
        "cdf_counts": lambda: pallas_histmatch.cdf_counts(
            ch["field"].reshape(B, -1), ch["edges"].contiguous()),
        "cdf_counts_one_value": lambda: pallas_histmatch.cdf_counts(
            x_one, ch["edges"].contiguous()),
        "chain": lambda: pallas_chain.match_warp_rim(
            ch["field"], ch["e8"], ch["T"], ch["q0"], ch["zval"], ch["ztrg"], ch["thr"],
            ch["dy"], ch["disp_t"], ch["cval"], ch["D"], ch["kr"], ch["r"], ch["do_rim"]),
        "unfused": unfused,
    })
    return out


def checksum(out):
    outs = out if isinstance(out, tuple) else (out,)
    return sum(float(torch.nan_to_num(o.double(), nan=0.0).sum()) for o in outs)


def time_rows(root, tag, out_file):
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import pysteps_tpu_torch
    from pysteps_tpu_torch.ops import (
        _kernels, pallas_chain, pallas_dilate, pallas_histmatch, pallas_warp,
    )
    # this checkout's chip_smoke.py (``root`` may hold an older one) for
    # its timers; its own imports of the port resolve to the copy already
    # loaded from ``root``
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] == "pysteps_tpu_torch" and getattr(mod, "__file__", None):
            if not Path(mod.__file__).resolve().is_relative_to(root):
                raise RuntimeError(f"{name} was imported from {mod.__file__}, not {root}")
    _kernels.build()
    inp = torch.load(INPUTS, map_location="cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    rec = {"tag": tag, "root": os.path.relpath(root, REPO),
           "package": os.path.relpath(pysteps_tpu_torch.__file__, REPO), "card": smi,
           "rows": {}}
    for name, fn in rows(inp, pallas_chain, pallas_dilate, pallas_histmatch,
                         pallas_warp).items():
        rec["rows"][name] = {"ms": cs.steady_ms(fn), "ms_eager": cs.eager_ms(fn),
                             "checksum": checksum(fn())}
    line = json.dumps(rec)
    print(line, flush=True)
    if out_file:
        with open(out_file, "a") as fh:
            fh.write(line + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save", action="store_true", help="draw and save the inputs")
    ap.add_argument("--root", help="checkout whose pysteps_tpu_torch to time")
    ap.add_argument("--tag", default="", help="label of the JSON line")
    ap.add_argument("--out", help="also append the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernel_times: needs a CUDA card")
    if args.save:
        save()
    if args.root:
        time_rows(args.root, args.tag, args.out)
    if not (args.save or args.root):
        ap.error("give --save, --root or both")


if __name__ == "__main__":
    main()
