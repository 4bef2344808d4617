"""The port's launchers (``python -m repro_torch.launch.<name>``)."""

XLA_OVERLAP = "--xla-overlap"
XLA_REFUSAL = (f"{XLA_OVERLAP}: XLA flags have no meaning in this package, "
               f"which compiles no XLA program")


def add_xla_overlap(ap) -> None:
    """The reference launchers' ``--xla-overlap``, accepted by the
    parser so that :func:`refuse_xla_overlap` can refuse it in one
    line (``src/repro/launch/xla.py`` has no counterpart here)."""
    ap.add_argument(XLA_OVERLAP, action="store_true",
                    help="refused: XLA flags have no meaning in this "
                         "package")


def refuse_xla_overlap(args) -> None:
    if getattr(args, "xla_overlap", False):
        raise SystemExit(XLA_REFUSAL)
