"""Time kernel K2 (``csrc/warp.cu``) at several tile geometries on the
shapes of paths B (32 x 1024^2) and C (96 x 320^2), D 48, beside the
two-pass kernels (th 0), on the same inputs in one run on one card.

    python3 scripts/tune_warp_tiles.py [--out FILE]

Each geometry (``pallas_warp.warp_tile``) is launched through
``pallas_warp._warp_launch``, held equal to the plain version and timed as
``chip_smoke.py`` times a row: the median of 5 replays of a CUDA graph of
100 calls.  The inputs are ``chip_smoke.py``'s: member fields around the
benchmark's last frame and smooth displacements of up to 45 px, drawn from
seed 0 on the card.  Prints one JSON line per shape, with the card's name
and power limit and the geometry ``warp_geometry`` chooses.  Needs one
CUDA card.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from pysteps_tpu_torch.ops import pallas_warp  # noqa: E402

GEOMETRIES = {  # (th, tw); th 0: the two-pass kernels
    "B": [(0, 0), (16, 1024), (8, 1024), (4, 1024), (16, 512), (8, 512), (16, 256)],
    "C": [(0, 0), (16, 320), (8, 320), (4, 320), (16, 128), (8, 128)],
}
TWO_PASS = {"route": "two_pass", "th": None, "tw": None, "cols": None, "smem_bytes": None}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_warp_tiles: needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    nan = float("nan")
    for label, (members, side, _) in (("B", cs.PATH_B), ("C", cs.PATH_C)):
        x, _ = cs.member_luts(gen, members, side)
        field = x.reshape(members, side, side).contiguous()
        disp = cs.smooth_displacements(gen, members, side, 45.0 / 1.6)
        dy = disp[:, 1].contiguous()
        disp_t = disp.transpose(-1, -2).contiguous()
        ref = pallas_warp._warp_fused_plain(field, dy, disp_t, 48, nan)
        rec = {"path": label, "shape": list(field.shape), "D": 48, "card": smi,
               "chosen": pallas_warp.warp_geometry(*field.shape, 48), "rows": []}
        for th, tw in GEOMETRIES[label]:
            geo = pallas_warp.warp_tile(*field.shape, 48, th, tw) if th else TWO_PASS

            def call(geo=geo):
                return pallas_warp._warp_launch(field, dy, disp_t, 48, nan, True, geo)

            out = call()
            same = bool(torch.equal(torch.isnan(out), torch.isnan(ref))
                        and torch.equal(out.nan_to_num(), ref.nan_to_num()))
            row = {"th": th, "tw": tw, "equal_to_plain": same, "ms": cs.steady_ms(call)}
            if th:
                row.update(smem_bytes=geo["smem_bytes"], **pallas_warp.warp_info(geo))
            rec["rows"].append(row)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        del x, field, disp, dy, disp_t, ref


if __name__ == "__main__":
    main()
