"""Drop-in CLI compatible with the reference `mgm` binary.

Flags mirror mgm.cc:302-318 (same names, same defaults, same
pick_option-style "-opt value" parsing) and the env vars mirror
mgm.cc:186-196 / mgm_costvolume.h:61, so every BASELINE.json config
line runs verbatim:

    python -m mgm_tpu_torch -r -120 -R 30 -O 4 u.png v.png disp.tif cost.tif

It runs on one CUDA device (`main(argv, device="cpu")` runs the plain
PyTorch versions of the kernels instead); it never falls back to the CPU
by itself.

Env honoured: CENSUS_NCC_WIN, TESTLRRL, TESTLRRL_TAU, MEDIAN, TSGM,
TSGM_ITER, TSGM_FIX_OVERCOUNT, USE_TRUNCATED_LINEAR_POTENTIALS,
TSGM_DEBUG, WITH_MGM2 (accepted; both code paths compute the same
math here, see mgm_core.cc:632-831 vs :408-613).
"""
from __future__ import annotations

import os
import sys

import torch

from .config import MGMConfig
from .io import read_image, write_image
from .stereo import compute_disparity

USAGE = "usage:\n\tmgm [-options] u v out [cost [backflow]]"

HELP = """Compute stereo disparities by the MGM algorithm (PyTorch/CUDA engine).

Usage: mgm [options] in_u in_v out_disp
   or: mgm [options] in_u in_v out_disp out_cost
   or: mgm [options] in_u in_v out_disp out_cost out_backflow

Options:
 -r {-30}          Minimum horizontal disparity value.
 -R {30}           Maximum horizontal disparity value.
 -O {4}            Number of search directions: 1..16
                   (the reference crashes above 8; 9..16 work here).
 -P1 {8}           SGM regularization parameter P1.
 -P2 {32}          SGM regularization parameter P2.
 -p {none}         Prefilter: none, census, sobelx, gblur.
 -t {ad}           Distance: census, ad, sd, ncc, btad, btsd.
 -truncDist {inf}  Truncate distances at nch * truncDist.
 -s {none}         Subpixel refinement: none, vfit, parabola, cubic.
 -aP1 {1}          Multiplier of P1 (parsed; unused, like the reference).
 -aP2 {1}          Multiplier of P2 when |I1-I2|^2 < nch*aThresh^2.
 -aThresh {5}      Threshold for the multiplier factors.
 -m FILE {none}    Per-pixel minimum disparity image.
 -M FILE {none}    Per-pixel maximum disparity image.
 -l FILE {none}    Write the disparity before the LR test here.
 -preset {none}    Named pipeline preset (fast_ad, census_tl, sobelx_tl,
                   satellite, full_16dir, ncc, bt); explicitly given
                   flags and env vars override the preset's values.

Environment: CENSUS_NCC_WIN=3 TESTLRRL=1 TESTLRRL_TAU=1 MEDIAN=0 TSGM=4
TSGM_ITER=1 TSGM_FIX_OVERCOUNT=1 USE_TRUNCATED_LINEAR_POTENTIALS=0
"""


def pick_option(argv: list[str], name: str, default: str | None) -> str | None:
    """Destructive '-name value' scan like mgm.cc:165-179."""
    flag = "-" + name
    for i, a in enumerate(argv):
        if a == flag and i + 1 < len(argv):
            val = argv[i + 1]
            del argv[i:i + 2]
            return val
    return default


def main(argv=None, device="cuda") -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--help" in argv or "-h" in argv:
        print(HELP)
        return 0
    if "--version" in argv:
        print("mgm-tpu-torch 1.0")
        return 0

    flag_names = ["r", "R", "O", "P1", "P2", "p", "t", "truncDist", "s",
                  "aP1", "aP2", "aThresh", "m", "M", "l"]
    explicit = {n for n in flag_names if ("-" + n) in argv}
    preset = pick_option(argv, "preset", "")
    opts = {}
    for name, dflt in [("r", "-30"), ("R", "30"), ("O", "4"), ("P1", "8"),
                       ("P2", "32"), ("p", "none"), ("t", "ad"),
                       ("truncDist", "inf"), ("s", "none"), ("aP1", "1"),
                       ("aP2", "1"), ("aThresh", "5"),
                       ("m", ""), ("M", ""), ("l", "")]:
        opts[name] = pick_option(argv, name, dflt)

    if len(argv) < 3:
        print(USAGE)
        return 1
    f_u, f_v, f_out = argv[0], argv[1], argv[2]
    f_cost = argv[3] if len(argv) > 3 else None
    f_back = argv[4] if len(argv) > 4 else None

    ndir = int(float(opts["O"]))
    if ndir > 16:
        print(f"NDIR={ndir} unsupported; using 16", file=sys.stderr)
        ndir = 16

    # flag/env -> MGMConfig field, value parser
    flag_fields = {
        "r": ("dmin", lambda v: int(float(v))),
        "R": ("dmax", lambda v: int(float(v))),
        "O": ("ndir", lambda v: ndir),
        "P1": ("p1", float), "P2": ("p2", float),
        "p": ("prefilter", str), "t": ("distance", str),
        "s": ("refinement", str),
        "truncDist": ("trunc_dist", float),
        "aP1": ("a_p1", float), "aP2": ("a_p2", float),
        "aThresh": ("a_thresh", float),
    }
    env_fields = {
        "CENSUS_NCC_WIN": ("census_ncc_win", lambda v: int(float(v))),
        "TSGM": ("mgm", lambda v: int(float(v))),
        "USE_TRUNCATED_LINEAR_POTENTIALS":
            ("use_trunc_linear", lambda v: bool(float(v))),
        "TSGM_FIX_OVERCOUNT": ("fix_overcount", lambda v: bool(float(v))),
        "TSGM_ITER": ("iterations", lambda v: int(float(v))),
        "MEDIAN": ("median_radius", lambda v: int(float(v))),
        "TESTLRRL": ("test_lr", lambda v: bool(float(v))),
        "TESTLRRL_TAU": ("lr_tau", float),
        "TSGM_DEBUG": ("debug", lambda v: bool(float(v))),
    }
    if preset:
        from .models.presets import get_preset

        try:
            cfg = get_preset(preset)
        except KeyError:
            print(f"unknown preset {preset!r}", file=sys.stderr)
            return 1
        # only explicitly-given flags / set env vars override the preset
        over = {fld: conv(opts[n]) for n, (fld, conv) in flag_fields.items()
                if n in explicit}
        over.update({fld: conv(os.environ[n])
                     for n, (fld, conv) in env_fields.items()
                     if os.environ.get(n) not in (None, "")})
        cfg = cfg.replace(**over)
    else:
        # defaults of the dataclass == reference defaults; set env vars
        # override them (mgm.cc:186-196)
        kw = {fld: conv(opts[n]) for n, (fld, conv) in flag_fields.items()}
        kw.update({fld: conv(os.environ[n])
                   for n, (fld, conv) in env_fields.items()
                   if os.environ.get(n) not in (None, "")})
        cfg = MGMConfig(**kw)

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch kernels on the CPU")
    u = read_image(f_u)
    v = read_image(f_v)
    dmin_img = read_image(opts["m"])[..., 0] if opts["m"] else None
    dmax_img = read_image(opts["M"])[..., 0] if opts["M"] else None

    res = compute_disparity(u, v, cfg, device=device, dmin_img=dmin_img,
                            dmax_img=dmax_img)

    if opts["l"]:
        write_image(opts["l"], res["disp_nolr"])
    write_image(f_out, res["disp"])
    if f_cost:
        write_image(f_cost, res["cost"])
    if f_back:
        write_image(f_back, res["backflow"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
