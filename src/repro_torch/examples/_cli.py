"""The examples' shared command line: ``--device`` (the card unless
``cpu``) and optional positional arguments."""
from __future__ import annotations

import argparse


def parse(description: str, *extra):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu (plain versions)")
    for name, kind, default in extra:
        ap.add_argument(name, type=kind, nargs="?", default=default)
    return ap.parse_args()
