"""The JAX package's seven ``examples/*.py`` on the port, one module
each, under the reference's file names and flags plus ``--device
{cuda,cpu}`` (``cuda`` by default; asking for the card without one
raises, nothing falls back to the CPU):

    python -m repro_torch.examples.<name> [flags] --device cpu

Each ``main(argv=None) -> dict`` returns what it printed (``lines``) and
what it computed.  Where a model is built, the body is a function that
takes the params, so a caller can run it on params made elsewhere (the
reference's, carried across with ``models.model.params_from_numpy``).
"""
from __future__ import annotations

import argparse


def add_device(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (default: the CUDA card; raises "
                         "without one)")
    return ap


def printer(lines: list):
    """A one-string ``print`` that also keeps each string in ``lines``."""
    def say(text: str) -> None:
        print(text, flush=True)
        lines.append(text)
    return say


__all__ = ["add_device", "printer"]
