"""CLI entry points and their shared argparse checks (``repro.launch``)."""
from __future__ import annotations

__all__ = ["add_amm_attn_arg", "resolve_amm_apply_to", "validate_amm_args",
           "validate_serve_flags"]

_SLICE3 = "ROADMAP slice 3 (the bitexact datapath and its int-code cache)"


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
    """``--kv-codes`` and ``--amm bitexact`` belong to a later slice."""
    if getattr(args, "kv_codes", False):
        raise NotImplementedError(f"--kv-codes: {_SLICE3}")
    if args.amm == "bitexact":
        raise NotImplementedError(f"--amm bitexact: {_SLICE3}")


def add_amm_attn_arg(ap) -> None:
    """The shared ``--amm-attn`` flag (bare: apply_to="all"; ``attn``:
    attention only).  Attention routing needs the bitexact datapath."""
    ap.add_argument("--amm-attn", nargs="?", const="all", default=None,
                    choices=["attn", "all"],
                    help="route the attention QK^T/PV products through the "
                         "approximate datapath too; needs --amm bitexact, "
                         f"which is {_SLICE3}")


def resolve_amm_apply_to(ap, args) -> str:
    """The (--amm, --mul, --amm-attn) combination -> apply_to."""
    if args.amm_attn is not None:
        raise NotImplementedError(f"--amm-attn: {_SLICE3}")
    return "mlp"
