"""CLI entry points and their shared argparse checks (``repro.launch``)."""
from __future__ import annotations

__all__ = ["add_amm_attn_arg", "resolve_amm_apply_to", "validate_amm_args",
           "validate_serve_flags"]

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
    """Reject ``--kv-codes`` combinations the code cache cannot serve, with
    the reference's rules: the int-code cache holds what the Booth
    attention lowering consumes, so it needs ``--amm bitexact``, a
    Booth-family ``--mul`` and ``--amm-attn``."""
    if not getattr(args, "kv_codes", False):
        return
    from ..kernels.ref import AMM_BOOTH_KINDS
    if args.amm != "bitexact":
        ap.error(f"--kv-codes stores Booth codes, which only the bitexact "
                 f"datapath consumes; got --amm {args.amm}")
    if args.mul not in AMM_BOOTH_KINDS:
        ap.error(f"--kv-codes needs a Booth-family --mul "
                 f"({sorted(AMM_BOOTH_KINDS)}); got --mul {args.mul!r}")
    if args.amm_attn is None:
        ap.error("--kv-codes caches the attention operands, so attention "
                 "must be amm-routed: pass --amm-attn (or --amm-attn attn)")


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
