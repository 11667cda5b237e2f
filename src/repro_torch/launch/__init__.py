"""CLI entry points and their shared argparse checks (``repro.launch``)."""
from __future__ import annotations

__all__ = ["add_amm_attn_arg", "resolve_amm_apply_to", "validate_amm_args",
           "validate_serve_flags"]

_SERVE_BITEXACT = ("bitexact serving with the int-code KV cache is ROADMAP "
                   "slice 5")


def validate_amm_args(ap, args) -> None:
    """Reject invalid (--mul, --wl, --vbl) combinations at parse time,
    with the reference's rules: a known multiplier family, an even word
    length in [4, 16] when an approximate mode is on, ``0 <= vbl < wl``
    for the Booth families."""
    if args.amm == "off":
        return
    from ..core.multipliers import MULTIPLIERS
    if args.mul not in MULTIPLIERS:
        ap.error(f"unknown --mul {args.mul!r}; choose from "
                 f"{sorted(MULTIPLIERS)}")
    if args.wl % 2 or not 4 <= args.wl <= 16:
        ap.error(f"--wl {args.wl} out of range: the approximate datapath "
                 f"needs an even word length in [4, 16]")
    if args.vbl < 0:
        ap.error(f"--vbl {args.vbl} must be non-negative")
    if args.mul in ("booth", "bbm0", "bbm1") and args.vbl >= args.wl:
        ap.error(f"--vbl {args.vbl} >= --wl {args.wl}: nullifying every "
                 f"product bit leaves no multiplier; VBL must be < WL")


def validate_serve_flags(ap, args) -> None:
    """The serve launcher's ``--kv-codes``, ``--amm bitexact`` and
    ``--amm-attn`` belong to a later slice; the train launcher takes the
    last two."""
    if getattr(args, "kv_codes", False):
        raise NotImplementedError(f"--kv-codes: {_SERVE_BITEXACT}")
    if args.amm == "bitexact":
        raise NotImplementedError(f"--amm bitexact: {_SERVE_BITEXACT}")
    if args.amm_attn is not None:
        raise NotImplementedError(f"--amm-attn: {_SERVE_BITEXACT}")


def add_amm_attn_arg(ap) -> None:
    """The shared ``--amm-attn`` flag (bare: apply_to="all"; ``attn``:
    attention only).  Attention routing needs --amm bitexact with a
    Booth-family --mul."""
    ap.add_argument("--amm-attn", nargs="?", const="all", default=None,
                    choices=["attn", "all"],
                    help="route the attention QK^T/PV products through the "
                         "approximate datapath too (bare flag: MLPs + "
                         "attention; 'attn': attention only); needs --amm "
                         "bitexact with a Booth-family --mul")


def resolve_amm_apply_to(ap, args) -> str:
    """The (--amm, --mul, --amm-attn) combination -> apply_to; rejects
    ``--amm-attn attn`` where it would approximate nothing."""
    from ..kernels.ref import AMM_BOOTH_KINDS
    if args.amm_attn == "attn" and not (
            args.amm == "bitexact" and args.mul in AMM_BOOTH_KINDS):
        ap.error("--amm-attn attn routes *only* attention, which needs "
                 "--amm bitexact with a Booth-family --mul; this "
                 "combination would approximate nothing")
    return args.amm_attn or "mlp"
